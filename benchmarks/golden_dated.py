"""Dated-directory + archive golden-corpus parity sweep (VERDICT r4 #5).

Sweeps the last unpinned reference behavior: the results directories the
r3/r4 parity harnesses skipped.

* ``results/archive/`` — 81 files in the final format, TWO codes: 30
  [[42,0]] (J=3) files at W=0..7 and 21..42 (the 8..20 band lives in the
  r4-swept ``[2,3,6,7,2,3]/`` dir) and 51 [[610,61]] flagship files at
  W=1..51, all MAX=100 p=0.02 at 100 000 samples.  The 610 series extends
  the swept corpus with the only p_0.02-LABELED [[610]] weight grid (the
  named [[610]] dirs are p_0.01-labeled; r2 found those actually ran at
  prior 0.02 — these archive files are labeled 0.02 outright and decode
  as labeled).
* ``results/11-20-2017_max_{50,100,1000}_iterations/`` — 5 files each: the
  J=2 [[42,7]] code (old ``code: J=2,...`` pretty-printer), W=1..5, at
  three DIFFERENT iteration caps — the only corpus data that varies MAX at
  fixed (code, W), pinning the cap-dependence of the convergence/corrected
  counters (``DecoderCPU.h:280-291`` loop bound).  No p in the filenames;
  p=0.02 assumed (the author's standard for the 42-qubit codes — every
  named [[42]] results file says p_0.02), recorded in the artifact note.

PROVENANCE FINDING (this sweep's own first run): every 2017-dated record
AND the archive's [[42,0]] series predate logical-error detection even
where the serializer prints a unified ``Logical Errors: 0`` — at weights
where ~15–80% of today's non-syndrome-fail samples are logical errors,
these files report logical ≡ 0 and a ``Corrected`` equal to our
corrected+logical within Monte-Carlo noise (e.g. [[42,0]] W=22: ref
corrected fraction 0.1499 vs our corrected+logical 0.1507, z=+0.6 — vs
z=-133 compared against corrected alone).  So ALL dated sections and the
[[42,0]] archive series compare with ``merge_logical=True``; only the
archive's [[610,61]] series (whose logical counts are too small to
distinguish eras, <2e-4) keeps the split comparison.
* ``results/11-18-2017_no_logical_error_detection/`` — 21 files (20
  parseable; ``ResultsCPU_RELEASE_2.txt`` is 0 bytes — an aborted run,
  excluded with that reason): the same
  J=2 code from a build PREDATING logical-error detection (split
  ``Logical Errors X/Z`` lines, all zero) with MAX unrecorded.  Counters
  that don't depend on the missing classifier stage — syndrome-fail X/Z,
  convergence-fail X/Z, and corrected+logical (what "Corrected" meant
  before the logical test was inserted between syndrome check and success,
  ``DecoderCPU.h:480-510``) — are compared against OUR runs at candidate
  MAX in {50, 100, 1000, 10000}; the artifact records which cap the data
  is consistent with (the first run's fit improved monotonically
  50 -> 100 -> 1000, so the higher candidates bracket it).

Parity scoring: two-proportion z for the common counters plus the exact
conditional-binomial two-sample test of benchmarks/golden_deep.py for the
rare ones (logical errors are 0 in every dated file).

One dynamic-weight compiled program per (code, MAX) — 4 programs for all
159 sweep points.

Usage (on the GPU):
    python -m benchmarks.golden_dated [out.jsonl] [samples_per_point]
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time

import numpy as np

from benchmarks.golden_deep import rate_parity_pvalue

RESULTS = "/root/reference/QEC_LDPC/results"
ARCHIVE_NAME_RE = re.compile(r"_W_(\d+)_MAX_(\d+)_p_([0-9.]+)\.txt$")


def _z(k_ref, n_ref, k_ours, n_ours):
    fr, fo = k_ref / n_ref, k_ours / n_ours
    sigma = float(np.sqrt(fr * (1 - fr) / n_ref
                          + fo * (1 - fo) / n_ours)) or 1e-9
    return round((fo - fr) / sigma, 3)


def read_archive_points():
    """[(code_params, weight, max_iters, p, ref_record)] — the archive mixes
    two codes, distinguished by the record's own Code string."""
    from qec_ldpc.harness import parse_code_params, parse_reference_text

    points = []
    for path in sorted(
            glob.glob(os.path.join(RESULTS, "archive", "*.txt"))):
        m = ARCHIVE_NAME_RE.search(os.path.basename(path))
        recs = parse_reference_text(open(path).read())
        if not m or not recs:
            continue
        points.append((parse_code_params(recs[0]["Code"]), int(m.group(1)),
                       int(m.group(2)), float(m.group(3)), recs[0]))
    return points


def read_dated_points(dirname: str):
    """[(weight, ref_record)] from a dated directory, weight taken from the
    record's own ``Error Weight`` line (filenames are just run indices)."""
    from qec_ldpc.harness import parse_reference_text

    points = []
    for path in sorted(glob.glob(os.path.join(RESULTS, dirname, "*.txt"))):
        for rec in parse_reference_text(open(path).read()):
            if "Error Weight" in rec:
                points.append((int(rec["Error Weight"]), rec,
                               os.path.basename(path)))
    return points


def main(out_path: str = "benchmarks/data/golden_dated_r5.jsonl",
         samples_per_point: str = str(2048 * 512)) -> int:
    import jax

    from benchmarks.common import setup_jax_cache

    setup_jax_cache()

    from functools import partial

    import jax.numpy as jnp

    from qec_ldpc.codes import construct_code
    from qec_ldpc.decoder import BPConfig, CodeGraphs
    from qec_ldpc.decoder.decode import decode_batch
    from qec_ldpc.sampling import (
        NUM_COUNTERS,
        classify_batch,
        sample_weight_w_errors_dynamic,
    )
    from qec_ldpc.sampling.classify import make_rank_basis_test

    count = int(samples_per_point)
    batch = 2048
    num_chunks = -(-count // batch)

    def build(J, K, L, P, s, t):
        code = construct_code(J, K, L, P, s, t)
        graphs = CodeGraphs.build(code)
        return code, graphs, make_rank_basis_test(code)

    code3, graphs3, ltest3 = build(3, 3, 6, 7, 2, 3)    # [[42,0]] archive
    code2, graphs2, ltest2 = build(2, 3, 6, 7, 2, 3)    # [[42,7]] dated
    code6, graphs6, ltest6 = build(4, 5, 10, 61, 9, 49)  # [[610,61]] archive
    by_params = {(3, 3, 6, 7, 2, 3): (code3, graphs3, ltest3, 48),
                 (4, 5, 10, 61, 9, 49): (code6, graphs6, ltest6, 56)}

    @partial(jax.jit,
             static_argnames=("graphs", "w_cap", "cfg", "batch",
                              "num_chunks"))
    def sweep_point(graphs, lt, key, weight, p, w_cap, cfg, batch,
                    num_chunks):
        def body(counters, c):
            ck = jax.random.fold_in(key, c)
            xe, ze = sample_weight_w_errors_dynamic(
                ck, graphs.code.n, weight, w_cap, batch)
            xe_i, ze_i = xe.astype(jnp.int32), ze.astype(jnp.int32)
            sx = graphs.x.syndrome(xe_i)
            sz = graphs.z.syndrome(ze_i)
            res = decode_batch(graphs, sx, sz, p, cfg)
            cnt = classify_batch(lt, xe_i, ze_i,
                                 res.decisions_x.astype(jnp.int32),
                                 res.decisions_z.astype(jnp.int32),
                                 res.error_code)
            return counters + cnt, None

        init = jnp.zeros(NUM_COUNTERS, jnp.int32)
        counters, _ = jax.lax.scan(
            body, init, jnp.arange(num_chunks, dtype=jnp.uint32))
        return counters

    def run_point(graphs, ltest, seed, w, max_iters, p, w_cap):
        cfg = BPConfig(max_iters=max_iters)
        t0 = time.perf_counter()
        counters = np.asarray(sweep_point(
            graphs, ltest, jax.random.PRNGKey(seed), jnp.int32(w),
            jnp.float32(p), w_cap, cfg, batch, num_chunks))
        return counters, time.perf_counter() - t0

    def compare(rec, ref, counters, merge_logical: bool):
        """z/p-value fields vs a reference record.  ``merge_logical``: the
        pre-detection builds counted today's logical errors as Corrected —
        compare ref Corrected against ours corrected+logical (see the
        PROVENANCE FINDING in the module docstring); ``ours_logical`` is
        still recorded raw."""
        rec["merged_logical"] = merge_logical
        if merge_logical:
            rec["ours_logical_raw"] = int(counters[6])
        n_ref = int(ref["Errors Tested"])
        n_ours = int(counters[0])
        rec.update({"ref_tested": n_ref, "ours_tested": n_ours})
        ours_corr = int(counters[3]) + (int(counters[6]) if merge_logical
                                        else 0)
        pairs = [("corrected", int(ref["Corrected"]), ours_corr),
                 ("syn_x", int(ref["Syndrome Errors X"]), int(counters[4])),
                 ("syn_z", int(ref["Syndrome Errors Z"]), int(counters[5])),
                 ("conv_x", int(ref["Convergence Fail X"]), int(counters[7])),
                 ("conv_z", int(ref["Convergence Fail Z"]), int(counters[8]))]
        if not merge_logical:
            pairs.insert(1, ("logical", int(ref["Logical Errors"]),
                             int(counters[6])))
        for name, kr, ko in pairs:
            rec[f"ref_{name}"] = kr
            rec[f"ours_{name}"] = ko
            rec[f"z_{name}"] = _z(kr, n_ref, ko, n_ours)
            rec[f"pvalue_{name}"] = round(
                rate_parity_pvalue(kr, n_ref, ko, n_ours), 6)
        return rec

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    t_all = time.perf_counter()
    records = []

    # ---- archive/: [[42,0]] W=0..29 and [[610,61]] W=1..51 grids ----
    archive = read_archive_points()
    for i, (params, w, max_iters, p, ref) in enumerate(archive):
        acode, agraphs, altest, w_cap = by_params[params]
        counters, dt = run_point(agraphs, altest, 5200 + w + params[0], w,
                                 max_iters, p, w_cap=w_cap)
        rec = compare({"section": "archive", "code": str(acode),
                       "weight": w, "max_iters": max_iters, "p": p,
                       "seconds": round(dt, 2)}, ref, counters,
                      # the WHOLE archive is pre-detection data: the
                      # [[42,0]] series showed it first, and the [[610]]
                      # series confirms (logical ≡ 0 in every ref file even
                      # at W=40..51 where the true logical rate is 1-35%,
                      # while syndrome/conv counters agree to noise)
                      merge_logical=True)
        records.append(rec)
        print(f"[archive {i + 1}/{len(archive)}] {acode.n=} W={w}: "
              f"corrected z={rec['z_corrected']:+.2f} "
              f"syn_x z={rec['z_syn_x']:+.2f} ({dt:.1f}s)", flush=True)

    # ---- 11-20 MAX sweep dirs: J=2 code, MAX in {50, 100, 1000} ----
    for dirname, max_iters in (
            ("11-20-2017_max_50_iterations", 50),
            ("11-20-2017_max_100_iterations", 100),
            ("11-20-2017_max_1000_iterations", 1000)):
        for w, ref, fname in read_dated_points(dirname):
            counters, dt = run_point(graphs2, ltest2, 5300 + max_iters + w,
                                     w, max_iters, 0.02, w_cap=24)
            rec = compare({"section": "max_sweep", "code": str(code2),
                           "file": fname, "weight": w,
                           "max_iters": max_iters, "p_assumed": 0.02,
                           "seconds": round(dt, 2)}, ref, counters,
                          # 11-20 files print 'Logical Errors: 0' but are
                          # pre-detection data too (PROVENANCE FINDING)
                          merge_logical=True)
            records.append(rec)
            print(f"[{dirname} W={w}] corrected z={rec['z_corrected']:+.2f} "
                  f"conv_z z={rec['z_conv_z']:+.2f} ({dt:.1f}s)", flush=True)

    # ---- 11-18 pre-detection dir: MAX unknown -> candidate scan ----
    for w, ref, fname in read_dated_points(
            "11-18-2017_no_logical_error_detection"):
        for max_iters in (50, 100, 1000, 10000):
            counters, dt = run_point(graphs2, ltest2,
                                     5400 + max_iters + w, w, max_iters,
                                     0.02, w_cap=24)
            rec = compare({"section": "pre_detection", "code": str(code2),
                           "file": fname, "weight": w,
                           "max_iters_candidate": max_iters,
                           "p_assumed": 0.02, "seconds": round(dt, 2)},
                          ref, counters, merge_logical=True)
            records.append(rec)
            print(f"[11-18 W={w} MAX?={max_iters}] corrected z="
                  f"{rec['z_corrected']:+.2f} syn_z z={rec['z_syn_z']:+.2f} "
                  f"conv_z z={rec['z_conv_z']:+.2f} ({dt:.1f}s)", flush=True)

    with open(out_path, "w") as f:
        meta = {
            "artifact": "golden_dated",
            "decoder": "sum-product",
            "samples_per_point": count,
            "device_kind": jax.devices()[0].device_kind,
            "points": len(records),
            "total_seconds": round(time.perf_counter() - t_all, 1),
            "note": ("parity sweep over the previously-unswept corpus "
                     "directories: archive/ ([[42,0]] W=0..7,21..42 and "
                     "[[610,61]] W=1..51), the 11-20-2017 MAX-sweep dirs "
                     "(J=2 [[42,7]], the only corpus axis varying the "
                     "iteration cap), and the 11-18-2017 dir (MAX "
                     "unrecorded -> candidate scan over "
                     "{50,100,1000,10000}).  PROVENANCE FINDING: every "
                     "dated record AND the [[42,0]] archive series are "
                     "pre-logical-detection data (their logical counters "
                     "are identically 0 and their Corrected equals our "
                     "corrected+logical within noise), so those sections "
                     "compare with merged_logical=true; the [[610,61]] "
                     "archive series keeps the split comparison.  Dated "
                     "dirs record no p; p=0.02 assumed (every named "
                     "[[42]] results file is p_0.02)."),
        }
        f.write(json.dumps(meta) + "\n")
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    zs = np.array([abs(r[k]) for r in records for k in r
                   if k.startswith("z_") and r.get("section") !=
                   "pre_detection"])
    print(f"wrote {out_path}: {len(records)} records; pinned-sections "
          f"median |z| {np.median(zs):.2f}, max |z| {zs.max():.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

# ---------------------------------------------------------------------------
# Provenance appendix (r5 chip experiments; summarized in the artifact note):
# the archive sections' residual 3-8 sigma drifts trace to EFFECTIVE
# iteration caps differing from the filenames' MAX=100 — [[42,0]] z's cross
# zero between MAX=80 and 100, parts of [[610]] between 100 and 120 — while
# prior-factor (2/3 vs 1) and convergence-check cadence (1 vs 10) were
# tested and ruled out.  The dev-era archive is therefore pinned at the
# syndrome level up to one unrecorded per-file knob; all final-format
# corpora match at their labeled MAX to noise.
# ---------------------------------------------------------------------------
