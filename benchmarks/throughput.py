"""Single-device decode-throughput matrix, one line per algorithm.

Runs the full Monte-Carlo pipeline (sample -> syndromes -> batched X/Z BP ->
classify -> counters) at a fixed iteration cap (convergence exit disabled and
verified), like bench.py, for every requested algorithm.
Emits one JSON line per algorithm:

  python benchmarks/throughput.py                      # default matrix
  python benchmarks/throughput.py --algorithms sum-product,min-sum \
      --iters 100 --batch 2048 --chunks 64

Baseline: the reference CPU harness at W=15/MAX=100/p=0.01 decodes 887
samples/s, i.e. <= 8.87e4 BP-iteration*samples/s for the whole machine
(SURVEY §6).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from benchmarks.common import BASELINE_ITER_SAMPLES_PER_S, best_time, emit, setup_jax_cache


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--code", type=int, nargs=6, default=[4, 5, 10, 61, 9, 49],
                    metavar=("J", "K", "L", "P", "sigma", "tau"))
    ap.add_argument("--algorithms",
                    default="sum-product,min-sum,layered-min-sum")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--weight", type=int, default=15)
    ap.add_argument("--p", type=float, default=0.01)
    args = ap.parse_args()

    setup_jax_cache()
    import jax
    import jax.numpy as jnp

    from qec_ldpc.codes import construct_code
    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.decoder.decode import CodeGraphs
    from qec_ldpc.parallel.montecarlo import _chunk_body
    from qec_ldpc.sampling import NUM_COUNTERS

    code = construct_code(*args.code)
    graphs = CodeGraphs.build(code)
    i_minus_p = jnp.asarray(code.i_minus_p)
    key = jax.random.PRNGKey(0)

    for algorithm in args.algorithms.split(","):
        algorithm = algorithm.strip()
        cfg = BPConfig(max_iters=args.iters, check_every=args.iters + 1,
                       layered_check_every=args.iters + 1,
                       algorithm=algorithm)

        @jax.jit
        def run(key, i_minus_p):
            def body(carry, c):
                counters, min_it = carry
                ck = jax.random.fold_in(key, c)
                cnt, iters = _chunk_body(graphs, i_minus_p, ck, args.weight,
                                         jnp.float32(args.p), cfg, args.batch,
                                         "weight")
                return (counters + cnt,
                        jnp.minimum(min_it, jnp.min(iters))), None
            init = (jnp.zeros(NUM_COUNTERS, jnp.int32), jnp.int32(2**31 - 1))
            (counters, min_it), _ = jax.lax.scan(
                body, init, jnp.arange(args.chunks, dtype=jnp.uint32))
            return counters, min_it

        def dispatch():
            counters, min_it = run(key, i_minus_p)
            counters = np.asarray(counters)
            # iters are lane-iteration sums: full work = iters per lane
            assert int(min_it) == args.iters * args.batch, (
                f"early exit leaked: {int(min_it)}")
            assert counters[0] == args.chunks * args.batch, counters

        secs = best_time(dispatch)
        samples = args.chunks * args.batch
        rate = samples * args.iters / secs
        emit({
            "metric": "bp_iteration_codewords_per_s_per_device",
            "algorithm": algorithm,
            "value": round(rate, 1),
            "samples_per_s": round(samples / secs, 1),
            "unit": (f"BP-iter*codewords/s/device (full pipeline, n={code.n} "
                     f"code, fixed {args.iters} iters, "
                     f"{args.chunks}x{args.batch} samples/dispatch)"),
            "vs_baseline": round(rate / BASELINE_ITER_SAMPLES_PER_S, 2),
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())
