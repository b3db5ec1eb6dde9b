"""Bivariate-bicycle LER / throughput benchmark (code-capacity noise).

Sweeps depolarizing error probability on a BB code (default: the
[[144,12,12]] gross code, codes/bicycle.py) with the lifted-graph decode
stack and emits one JSON line per (p, mode):

  python benchmarks/bicycle_ler.py --ps 0.01,0.02,0.03 --count 20000
  python benchmarks/bicycle_ler.py --relay 12 --osd 20   # quality stack

Modes compose like the flagship harness: flooding min-sum on the lifted
graph, optional on-device ensemble relay repair, optional
host BP+OSD mop-up (the standard decoder for BB codes in the literature).
There is no reference corpus for these codes (the reference implements only
the Hagiwara–Imai family) — numbers stand on their own and document what the
framework adds beyond reference parity.
"""

from __future__ import annotations

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from benchmarks.common import emit, setup_jax_cache


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--code", default="[[144,12,12]]",
                    help="published BB instance label (codes/bicycle.py)")
    ap.add_argument("--ps", default="0.01,0.02,0.03,0.04,0.05")
    ap.add_argument("--count", type=int, default=20_000)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps-per-call", type=int, default=8)
    ap.add_argument("--seed", type=int, default=20260820)
    ap.add_argument("--osd", type=int, default=-1, metavar="LAM",
                    help="-1 off; >=0 OSD with lam-column combination sweep")
    ap.add_argument("--relay", type=int, default=0, metavar="RETRIES")
    args = ap.parse_args()

    setup_jax_cache()
    import numpy as np

    from qec_ldpc.codes import known_bicycle_code
    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.parallel.montecarlo import run_monte_carlo, run_monte_carlo_osd

    code = known_bicycle_code(args.code)
    graphs = code.build_graphs()
    cfg = BPConfig(max_iters=args.iters, algorithm="min-sum")
    mode = "min-sum"
    if args.relay:
        mode += f"+relay{args.relay}"
    if args.osd >= 0:
        mode += f"+osd{args.osd}"

    def run(p):
        if args.osd >= 0:
            return run_monte_carlo_osd(
                graphs, 0, args.count, p, cfg, args.seed,
                batch_size=args.batch, lam=args.osd,
                error_model="depolarizing", relay_retries=args.relay)
        return run_monte_carlo(
            graphs, 0, args.count, p, cfg, args.seed,
            batch_size=args.batch, error_model="depolarizing",
            steps_per_call=args.steps_per_call,
            relay_retries=args.relay)

    ps = [float(x) for x in args.ps.split(",")]
    run(ps[0])  # compile + warm up (shapes are p-independent)
    for p in ps:
        t0 = time.perf_counter()
        counters, iters = run(p)
        dt = time.perf_counter() - t0
        c = np.asarray(counters, dtype=np.int64)
        emit({
            "benchmark": "bicycle_ler",
            "code": str(code),
            "mode": mode,
            "p": p,
            "tested": int(c[0]),
            "corrected_fraction": round(float(c[3] / c[0]), 6),
            "logical_fraction": round(float(c[6] / c[0]), 6),
            "syndrome_fail_fraction": round(float((c[4] + c[5]) / c[0]), 6),
            "samples_per_s": round(c[0] / dt, 1),
            "executed_bp_lane_iters_per_s": round(int(iters) / dt, 1),
            "max_iters": args.iters,
            "seed": args.seed,
        })
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
