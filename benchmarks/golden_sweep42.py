"""Full [[42,0]] golden-corpus parity sweep: plain sum-product BP.

Completes corpus coverage across BOTH shipped codes: the [[610,61]] corpus
is fully swept (``golden_sweep.py``, 122 points) and count-pinned at depth
(``golden_deep.py``); this sweeps EVERY [[42,0]] corpus file
(``results/[2,3,6,7,2,3]/`` — 59 files across W=1..30 and
MAX ∈ {100, 1000, 5000, 10000, 100000}, all at p=0.02).  Unlike the
[[610]] corpus, the [[42]] runs match at their LABELED prior (r3
provenance finding), so every point decodes at p=0.02 exactly as labeled.

The [[42,0]] code is the reference's degenerate k=0 instance where BP
mostly FAILS (e.g. W=10/MAX=100: 5 corrected of 100 000) — the corpus
pins the failure-mode counters (syndrome-fail, conv-fail, "logical")
rather than successes, so this sweep exercises the classification lattice
in exactly the regime the [[610]] sweep cannot.

One dynamic-weight compiled program per distinct MAX (5 programs total).

Usage (on the GPU):
    python -m benchmarks.golden_sweep42 [out.jsonl] [samples_per_point]
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time

import numpy as np

REF_DIR = "/root/reference/QEC_LDPC/results/[2,3,6,7,2,3]"
NAME_RE = re.compile(r"_W_(\d+)_MAX_(\d+)_p_([0-9.]+)\.txt$")


def read_golden_points():
    from qec_ldpc.harness import parse_reference_text

    points = []
    for path in sorted(glob.glob(os.path.join(glob.escape(REF_DIR), "*.txt"))):
        m = NAME_RE.search(os.path.basename(path))
        if not m:
            continue
        recs = parse_reference_text(open(path).read())
        if not recs:
            continue
        points.append((int(m.group(1)), int(m.group(2)), float(m.group(3)),
                       recs[0]))
    return points


def main(out_path: str = "benchmarks/data/golden_sweep42_r4.jsonl",
         samples_per_point: str = "10240") -> int:
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
    code = construct_code(3, 3, 6, 7, 2, 3)
    graphs = CodeGraphs.build(code)
    ltest = make_rank_basis_test(code)
    W_MAX = 32  # corpus tops out at W=30
    batch = 2048
    # worst-case lane-iteration budget per point: this code is degenerate
    # (BP mostly FAILS at W >= 21, running the full MAX), so a flat
    # samples-per-point at MAX=100000 means ~2e11 lane-iterations in one
    # point — hours of device time in a single scan.
    # Points are therefore capped at ITER_BUDGET pessimistic lane-iters
    # (MAX<=1000 keeps the full count; MAX=10000 ~400k samples; MAX=100000
    # ~40k — still 4x the r4 depth at those points), and scans are split
    # into <=64-chunk dispatches so each dispatch stays short.
    ITER_BUDGET = 8_000_000_000

    @partial(jax.jit, static_argnames=("cfg", "batch", "group"))
    def sweep_group(lt, key, weight, p, cfg, batch, group,
                    chunk0):
        def body(counters, c):
            ck = jax.random.fold_in(key, c)
            xe, ze = sample_weight_w_errors_dynamic(
                ck, graphs.code.n, weight, W_MAX, batch)
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
            body, init, chunk0 + jnp.arange(group, dtype=jnp.uint32))
        return counters

    def sweep_point(lt, key, weight, p, cfg, batch, num_chunks):
        total = np.zeros(NUM_COUNTERS, np.int64)
        for g0 in range(0, num_chunks, 64):
            group = min(64, num_chunks - g0)
            total += np.asarray(sweep_group(
                lt, key, weight, p, cfg, batch, group,
                jnp.uint32(g0)), dtype=np.int64)
        return total

    points = read_golden_points()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    t_all = time.perf_counter()
    records = []
    for i, (w, max_iters, p, ref) in enumerate(points):
        n_ref = int(ref["Errors Tested"])
        cfg = BPConfig(max_iters=max_iters)
        # pessimistic (all-lanes-fail) lane-iteration budget cap
        samples_cap = max(batch, ITER_BUDGET // (2 * max_iters))
        point_count = min(count, samples_cap)
        num_chunks = -(-point_count // batch)
        t0 = time.perf_counter()
        # seed folds in MAX: r4 seeded 4200+w only, so every MAX variant of
        # a weight decoded the SAME sample stream — their deviations from
        # the reference were correlated by construction, which is exactly
        # the shape of the r4 W=11 syn_x "z-cluster" (three same-sign z's
        # at MAX=1000/10000/100000; VERDICT r4 weak #4).  Independent
        # streams make same-sign clusters evidence instead of artifact.
        counters = np.asarray(sweep_point(
            ltest, jax.random.PRNGKey(4200 + w + 101 * max_iters),
            jnp.int32(w), jnp.float32(p), cfg, batch, num_chunks))
        dt = time.perf_counter() - t0
        n_ours = int(counters[0])

        from benchmarks.golden_deep import rate_parity_pvalue

        pvals = {}

        def frac_and_z(field, ours_idx):
            kr, ko = int(ref[field]), int(counters[ours_idx])
            fr, fo = kr / n_ref, ko / n_ours
            sigma = float(np.sqrt(fr * (1 - fr) / n_ref
                                  + fo * (1 - fo) / n_ours)) or 1e-9
            # exact conditional-binomial two-sample test alongside the z
            # (VERDICT r4 #4: exact tests throughout the deep sweep)
            pvals[field] = round(rate_parity_pvalue(kr, n_ref, ko, n_ours), 6)
            return fr, fo, round((fo - fr) / sigma, 3)

        rc, oc, zc = frac_and_z("Corrected", 3)
        rl, ol, zl = frac_and_z("Logical Errors", 6)
        rsx, osx, zsx = frac_and_z("Syndrome Errors X", 4)
        rsz, osz, zsz = frac_and_z("Syndrome Errors Z", 5)
        rcx, ocx, zcx = frac_and_z("Convergence Fail X", 7)
        rcz, ocz, zcz = frac_and_z("Convergence Fail Z", 8)
        rec = {
            "weight": w, "p": p, "max_iters": max_iters,
            "ref_tested": n_ref, "ours_tested": n_ours,
            "ref_corrected_fraction": round(rc, 6),
            "ours_corrected_fraction": round(oc, 6),
            "z_corrected": zc,
            "ref_logical_fraction": round(rl, 6),
            "ours_logical_fraction": round(ol, 6),
            "z_logical": zl,
            "ref_syn_x_fraction": round(rsx, 6),
            "ours_syn_x_fraction": round(osx, 6),
            "z_syn_x": zsx,
            "ref_conv_x_fraction": round(rcx, 6),
            "ours_conv_x_fraction": round(ocx, 6),
            "z_conv_x": zcx,
            "ref_syn_z_fraction": round(rsz, 6),
            "ours_syn_z_fraction": round(osz, 6),
            "z_syn_z": zsz,
            "ref_conv_z_fraction": round(rcz, 6),
            "ours_conv_z_fraction": round(ocz, 6),
            "z_conv_z": zcz,
            **{f"pvalue_{k.lower().replace(' ', '_')}": v
               for k, v in pvals.items()},
            "seconds": round(dt, 3),
        }
        records.append(rec)
        print(f"[{i + 1}/{len(points)}] W={w} MAX={max_iters}: "
              f"corrected z={zc:+.2f} logical z={zl:+.2f} "
              f"syn_x z={zsx:+.2f} conv_x z={zcx:+.2f} ({dt:.1f}s)",
              flush=True)

    with open(out_path, "w") as f:
        meta = {
            "artifact": "golden_sweep42", "code": str(code),
            "decoder": "sum-product",
            "samples_per_point": count,
            "iter_budget_per_point": ITER_BUDGET,
            "device_kind": jax.devices()[0].device_kind,
            "points": len(records),
            "total_seconds": round(time.perf_counter() - t_all, 1),
            "note": ("every [[42,0]] corpus file at its LABELED prior "
                     "(r3 finding: this corpus matches at p as labeled); "
                     "the failure-regime counters are the signal here — "
                     "the code is degenerate (k=0) and BP mostly fails. "
                     "r5: per-point seeds fold in MAX (the r4 W=11 "
                     "'z-cluster' was three MAX variants sharing one "
                     "sample stream — correlated our-side noise, not a "
                     "decoder discrepancy; see the seed comment), and "
                     "exact conditional-binomial two-sample pvalue_* "
                     "fields accompany every z"),
        }
        f.write(json.dumps(meta) + "\n")
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    zs = np.array([[abs(r["z_corrected"]), abs(r["z_logical"]),
                    abs(r["z_syn_x"]), abs(r["z_conv_x"])] for r in records])
    print(f"wrote {out_path}: {len(records)} points; median |z| "
          f"{np.median(zs):.2f}, max |z| {zs.max():.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
