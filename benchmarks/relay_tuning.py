"""Relay damping-range tuning on the codes that matter.

VERDICT r3 weak #4: the relay defaults gamma ~ U[0.2, 0.95) were tuned on
the P=7 toy code (commit 0f4ea80); the quality sweeps then apply them to
[[610,61]] and BB codes untested.  This benchmark repeats the methodology on
the flagship workloads: draw a batch, decode with flooding min-sum, take the
lanes whose hard decision violates the syndrome (the relay's actual input
population), and measure — per candidate gamma range, over several disjoint
seeds — the fraction of those failures a 16-retry relay repairs, plus the
corrected fraction after classification of the repaired batch.

gamma_low/high are traced arguments of ``relay_decode_batch``, so the whole
sweep reuses one compiled program per code.

Usage (on the GPU):  python -m benchmarks.relay_tuning [out.jsonl]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from benchmarks.common import setup_jax_cache

RANGES = [(0.2, 0.95), (0.1, 0.9), (0.5, 0.99), (0.3, 0.8),
          (0.05, 1.0), (0.4, 0.95), (0.2, 0.7)]
RETRIES = 16
SEEDS = (3, 7, 11)


def main(out_path: str = "benchmarks/data/relay_tuning_r4.jsonl") -> int:
    setup_jax_cache()
    import jax
    import jax.numpy as jnp

    from qec_ldpc.codes import construct_code, known_bicycle_code
    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.decoder.decode import (
        SYNDROME_FAIL_X,
        SYNDROME_FAIL_Z,
        CodeGraphs,
        decode_batch,
    )
    from qec_ldpc.decoder.relay import relay_decode_batch
    from qec_ldpc.sampling import (
        classify_batch,
        sample_depolarizing_errors,
        sample_weight_w_errors,
    )
    from qec_ldpc.sampling.classify import make_rank_basis_test

    records = []

    def workload(name, graphs, sampler, p, batch=4096):
        cfg = BPConfig(max_iters=100, algorithm="min-sum")
        ltest = make_rank_basis_test(graphs.code)
        syn_bits = SYNDROME_FAIL_X | SYNDROME_FAIL_Z

        @jax.jit
        def one(key, lo, hi):
            xe, ze = sampler(key, batch)
            xe_i, ze_i = xe.astype(jnp.int32), ze.astype(jnp.int32)
            sx = graphs.x.syndrome(xe_i)
            sz = graphs.z.syndrome(ze_i)
            base = decode_batch(graphs, sx, sz, p, cfg)
            n_fail0 = jnp.sum((base.error_code & syn_bits) != 0)
            rk = jax.random.fold_in(key, jnp.uint32(0x52454C41))
            res, _, _ = relay_decode_batch(
                graphs, sx, sz, p, rk, cfg, retries=RETRIES,
                gamma_low=lo, gamma_high=hi)
            n_fail1 = jnp.sum((res.error_code & syn_bits) != 0)
            cnt = classify_batch(ltest, xe_i, ze_i,
                                 res.decisions_x.astype(jnp.int32),
                                 res.decisions_z.astype(jnp.int32),
                                 res.error_code)
            return n_fail0, n_fail1, cnt

        for lo, hi in RANGES:
            fail0 = fail1 = corrected = tested = 0
            t0 = time.perf_counter()
            for seed in SEEDS:
                f0, f1, cnt = one(jax.random.PRNGKey(seed),
                                  jnp.float32(lo), jnp.float32(hi))
                fail0 += int(f0)
                fail1 += int(f1)
                cnt = np.asarray(cnt)
                corrected += int(cnt[3])
                tested += int(cnt[0])
            rec = {
                "code": name, "gamma_low": lo, "gamma_high": hi,
                "retries": RETRIES, "seeds": len(SEEDS),
                "batch_per_seed": batch,
                "bp_failures": fail0, "unrepaired": fail1,
                "repair_rate": round(1 - fail1 / max(fail0, 1), 4),
                "corrected_fraction": round(corrected / tested, 5),
                "seconds": round(time.perf_counter() - t0, 2),
            }
            records.append(rec)
            print(f"{name} gamma[{lo},{hi}): repair "
                  f"{rec['repair_rate']:.3f} ({fail0} failures), "
                  f"corrected {rec['corrected_fraction']:.5f}", flush=True)

    # [[610,61]] at the high-weight end of the corpus (prior 0.02 per the
    # provenance rule), where relay actually has work to do
    code = construct_code(4, 5, 10, 61, 9, 49)
    graphs = CodeGraphs.build(code)
    for w in (40, 50):
        workload(
            f"qc610_W{w}", graphs,
            lambda key, batch, _w=w: sample_weight_w_errors(
                key, code.n, _w, batch),
            p=0.02)

    # BB [[144,12,12]] at depolarizing p where BP starts failing
    bb = known_bicycle_code("[[144,12,12]]")
    bb_graphs = bb.build_graphs()
    for p in (0.02, 0.03):
        workload(
            f"bb144_p{p}", bb_graphs,
            lambda key, batch, _p=p: sample_depolarizing_errors(
                key, bb.n, _p, batch),
            p=p)

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(json.dumps({
            "artifact": "relay_tuning",
            "note": ("gamma-range sweep on flagship codes (VERDICT r3 weak "
                     "#4); repair_rate = fraction of BP syndrome failures "
                     "fixed by a 16-retry relay; corrected_fraction is "
                     "post-relay classification of the full batch"),
        }) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
