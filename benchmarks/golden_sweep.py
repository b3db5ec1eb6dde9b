"""Full [[610,61]] golden-corpus weight-sweep parity: plain sum-product BP.

VERDICT r2 weak #2: the de-facto regression corpus
(``/root/reference/QEC_LDPC/results/[4,5,10,61,9,49]/`` — 60 weights x
p in {0.01, 0.02}, ``CodeStatistics`` text dumps) deserves a committed
apples-to-apples sweep: SAME decoder family (probability-domain sum-product,
NO relay/OSD repair), same W/MAX/p per point, our sample count matched to
each golden file's.  Emits one JSONL record per sweep point with both sides'
fractions and the binomial z-score of the difference; the committed artifact
is pinned by tests/test_golden_parity.py.

Usage (on the GPU):
    python -m benchmarks.golden_sweep [out.jsonl]

Provenance note on the p=0.02 points: the reference ran only 1 000 samples
each there (vs 10 000 at p=0.01), so their binomial noise floor is ~3x
higher; the z-score gate accounts for both sides' sample counts.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time

import numpy as np

REF_DIR = "/root/reference/QEC_LDPC/results/[4,5,10,61,9,49]"
NAME_RE = re.compile(r"_W_(\d+)_MAX_(\d+)_p_([0-9.]+)\.txt$")


def read_golden_points():
    """[(weight, max_iters, p, record_dict)] for every [[610]] corpus file."""
    from qec_ldpc.harness import parse_reference_text

    points = []
    # glob.escape: the corpus directory name is [4,5,10,61,9,49] — a literal
    # bracket expression that glob would otherwise parse as a char class
    for path in sorted(glob.glob(os.path.join(glob.escape(REF_DIR), "*.txt"))):
        m = NAME_RE.search(os.path.basename(path))
        if not m:
            continue
        recs = parse_reference_text(open(path).read())
        if not recs:  # one corpus file (W_60_MAX_100000) is empty
            continue
        points.append((int(m.group(1)), int(m.group(2)), float(m.group(3)),
                       recs[0]))
    return points


def main(out_path: str = "benchmarks/data/golden_sweep_r3.jsonl") -> int:
    import jax

    from qec_ldpc.harness.cli import enable_persistent_compile_cache

    enable_persistent_compile_cache()

    import jax.numpy as jnp
    from functools import partial

    from qec_ldpc.codes import construct_code
    from qec_ldpc.decoder import BPConfig, CodeGraphs
    from qec_ldpc.decoder.decode import decode_batch
    from qec_ldpc.sampling import (
        NUM_COUNTERS,
        classify_batch,
        sample_weight_w_errors_dynamic,
    )
    from qec_ldpc.sampling.classify import make_rank_basis_test

    code = construct_code(4, 5, 10, 61, 9, 49)
    graphs = CodeGraphs.build(code)
    ltest = make_rank_basis_test(code)
    W_MAX = 64  # corpus tops out at W=58

    # ONE compiled program per distinct chunk count for the WHOLE sweep:
    # weight is a runtime value via the dynamic sampler, p is traced, so the
    # 120 points do not cost 120 compilations.
    @partial(jax.jit, static_argnames=("cfg", "batch", "num_chunks"))
    def sweep_point(lt, key, weight, p, cfg, batch, num_chunks):
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
            body, init, jnp.arange(num_chunks, dtype=jnp.uint32))
        return counters

    points = read_golden_points()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    t_all = time.perf_counter()
    records = []
    for i, (w, max_iters, p, ref) in enumerate(points):
        ref_tested = int(ref["Errors Tested"])
        ref_corrected = int(ref["Corrected"])
        # one device dispatch per point: count rounded up to whole chunks
        batch = 2048
        cfg = BPConfig(max_iters=max_iters)
        num_chunks = -(-ref_tested // batch)
        t0 = time.perf_counter()
        counters = np.asarray(sweep_point(
            ltest, jax.random.PRNGKey(1000 + w), jnp.int32(w),
            jnp.float32(p), cfg, batch, num_chunks))
        dt = time.perf_counter() - t0
        tested = int(counters[0])
        pr = ref_corrected / ref_tested
        po = int(counters[3]) / tested

        def z(p_ours, n_ours):
            sigma = float(np.sqrt(pr * (1 - pr) / ref_tested
                                  + p_ours * (1 - p_ours) / n_ours)) or 1e-9
            return round((p_ours - pr) / sigma, 3)

        # provenance correction (round-2 finding, ARCHITECTURE.md testing
        # notes): the reference's p_0.01-labeled [[610]] runs were evidently
        # generated with prior p=0.02 (their fractions are statistically
        # identical to the p_0.02 files), so for those points we ALSO decode
        # at 0.02 — the apples-to-apples prior — and gate on that z.
        corrected_extra = {}
        if p == 0.01:
            c2 = np.asarray(sweep_point(
                ltest, jax.random.PRNGKey(1000 + w), jnp.int32(w),
                jnp.float32(0.02), cfg, batch, num_chunks))
            po2 = int(c2[3]) / int(c2[0])
            corrected_extra = {
                "ours_corrected_fraction_prior002": round(po2, 6),
                "z_score_prior002": z(po2, int(c2[0])),
            }
        rec = {
            "weight": w, "p": p, "max_iters": max_iters,
            "ref_tested": ref_tested, "ref_corrected": ref_corrected,
            "ref_logical": int(ref["Logical Errors"]),
            "ref_syn_x": int(ref["Syndrome Errors X"]),
            "ref_syn_z": int(ref["Syndrome Errors Z"]),
            "ours_tested": tested, "ours_corrected": int(counters[3]),
            "ours_logical": int(counters[6]),
            "ours_syn_x": int(counters[4]), "ours_syn_z": int(counters[5]),
            "ref_corrected_fraction": round(pr, 6),
            "ours_corrected_fraction": round(po, 6),
            "z_score": z(po, tested),
            **corrected_extra,
            "seconds": round(dt, 3),
        }
        records.append(rec)
        print(f"[{i + 1}/{len(points)}] W={w} p={p}: ref {pr:.4f} "
              f"ours {po:.4f} z={rec['z_score']:+.2f}"
              + (f" z@0.02={rec['z_score_prior002']:+.2f}"
                 if corrected_extra else "")
              + f" ({dt:.1f}s)", flush=True)
    with open(out_path, "w") as f:
        meta = {
            "artifact": "golden_sweep", "code": str(code),
            "decoder": "sum-product",
            "device_kind": jax.devices()[0].device_kind,
            "points": len(records),
            "total_seconds": round(time.perf_counter() - t_all, 1),
            "note": ("apples-to-apples plain BP vs the reference corpus; "
                     "p=0.02 golden files hold only 1000 samples each "
                     "(3x the binomial noise of the p=0.01 files); the "
                     "p_0.01-labeled reference runs were generated with "
                     "prior p=0.02 (round-2 provenance finding), so those "
                     "points carry a z_score_prior002 field decoded at the "
                     "true generation prior — the parity gate"),
        }
        f.write(json.dumps(meta) + "\n")
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    zs = np.array([abs(r.get("z_score_prior002", r["z_score"]))
                   for r in records])
    print(f"wrote {out_path}: {len(records)} points, provenance-corrected "
          f"median |z| = {np.median(zs):.2f}, max |z| = {zs.max():.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
