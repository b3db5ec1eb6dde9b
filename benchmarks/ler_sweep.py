"""Logical-error-rate curve benchmark vs the reference golden corpus.

Runs the production Monte-Carlo harness (convergence early exit ON, honest
per-tile iteration accounting) over a weight sweep on the [[610,61]] flagship
code and compares outcome fractions against the reference's committed results
(/root/reference/QEC_LDPC/results/, SURVEY §6) when they are available.
Emits one JSON line per weight:

  python benchmarks/ler_sweep.py --weights 10,20,30,40,50 --count 10000

Corpus-provenance note (established empirically, 2026-08): the reference's
[[610,61]] results directory labels files ``p_0.01`` AND ``p_0.02``, but BOTH
sets have statistically identical outcome fractions, and both match our
decoder only when the BP prior is 2/3*0.02 — e.g. at W=30 the reference
reports corrected 0.9452 / synZ 0.0345 and we measure 0.9432 / 0.0345 at
p=0.02 vs 0.9121 / 0.0567 at p=0.01.  (The [[42,0]] corpus, by contrast,
matches us at its labeled p at every weight.)  So the [[610]] runs were
evidently produced with an effective error-probability of 0.02 regardless of
the file label; this benchmark therefore decodes at --p 0.02 by default while
pulling reference numbers from the ``p_0.01``-labeled files (--ref-label-p).
"""

from __future__ import annotations

import argparse
import glob
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from benchmarks.common import emit, setup_jax_cache

REF_GLOB = ("/root/reference/QEC_LDPC/results/[[]{spec}[]]/"
            "*_W_{w}_MAX_{m}_p_{p}.txt")


def reference_fractions(code_params, weight: int, max_iters: int,
                        p_label: float):
    """(corrected, logical, tested) from the reference corpus for the code
    with these (J,K,L,P,sigma,tau) params, or None.  ``p_label`` is the p in
    the FILE NAME (see provenance note above)."""
    from qec_ldpc.harness.stats import parse_reference_text

    spec = ",".join(str(x) for x in code_params)
    pat = REF_GLOB.format(spec=spec, w=weight, m=max_iters, p=p_label)
    recs = []
    for path in glob.glob(pat):
        with open(path) as f:
            recs.extend(parse_reference_text(f.read()))
    if not recs:
        return None
    tested = sum(int(r["Errors Tested"]) for r in recs)
    corrected = sum(int(r["Corrected"]) for r in recs)
    logical = sum(int(r["Logical Errors"]) for r in recs)
    return corrected / tested, logical / tested, tested


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--code", type=int, nargs=6, default=[4, 5, 10, 61, 9, 49],
                    metavar=("J", "K", "L", "P", "sigma", "tau"))
    ap.add_argument("--weights", default="10,20,30,40,50")
    ap.add_argument("--count", type=int, default=10_000)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--p", type=float, default=0.02,
                    help="decode prior p (default 0.02: what the [[610]] "
                         "corpus actually used — see provenance note)")
    ap.add_argument("--ref-label-p", type=float, default=0.01,
                    help="p as it appears in reference file names")
    ap.add_argument("--algorithm", default="sum-product",
                    help="sum-product (reference-faithful) | min-sum | "
                         "layered-min-sum")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps-per-call", type=int, default=32,
                help="chunks scanned per dispatch (amortizes per-dispatch host overhead)")
    ap.add_argument("--seed", type=int, default=20260818)
    ap.add_argument("--osd", type=int, default=-1, metavar="LAM",
                    help="OSD post-processing of BP failures: -1 off, "
                         "0 OSD-0, >0 combination-sweep depth (quality "
                         "mode; host round-trip per chunk)")
    ap.add_argument("--relay", type=int, default=0, metavar="RETRIES",
                    help="on-device ensemble relay repairs before OSD: "
                         "number of randomized damped min-sum retries")
    args = ap.parse_args()

    setup_jax_cache()
    from qec_ldpc.codes import construct_code
    from qec_ldpc.decoder import BPConfig, CodeGraphs
    from qec_ldpc.parallel import run_monte_carlo, run_monte_carlo_osd
    from qec_ldpc.sampling import (
        C_CONV_X, C_CONV_Z, C_CORRECTED, C_LOGICAL, C_SYN_X, C_SYN_Z, C_TESTED,
    )

    code = construct_code(*args.code)
    graphs = CodeGraphs.build(code)
    cfg = BPConfig(max_iters=args.iters,
                   algorithm=args.algorithm)

    # round count UP to a whole number of dispatch groups so every dispatch
    # has one compiled shape; then one group-sized warm-up run per weight
    # covers compilation and the timed sweep is compile-free
    group = args.batch * args.steps_per_call
    count = -(-args.count // group) * group
    for w in (int(x) for x in args.weights.split(",")):
        if args.osd >= 0:
            # host-OSD quality mode (relay optionally first)
            run_monte_carlo_osd(graphs, w, args.batch, args.p, cfg,
                                seed=args.seed + w, batch_size=args.batch,
                                lam=args.osd, relay_retries=args.relay)  # warm-up
            t0 = time.perf_counter()
            counters, bp_iters = run_monte_carlo_osd(
                graphs, w, count, args.p, cfg, seed=args.seed + w,
                batch_size=args.batch, lam=args.osd,
                relay_retries=args.relay)
        else:
            # pure-device path — relay (if any) composes with the on-device
            # chunk scan, same as the CLI's routing
            run_monte_carlo(graphs, w, group, args.p, cfg, seed=args.seed + w,
                            batch_size=args.batch,
                            steps_per_call=args.steps_per_call,
                            relay_retries=args.relay)  # warm-up
            t0 = time.perf_counter()
            counters, bp_iters = run_monte_carlo(
                graphs, w, count, args.p, cfg, seed=args.seed + w,
                batch_size=args.batch, steps_per_call=args.steps_per_call,
                relay_retries=args.relay)
        secs = time.perf_counter() - t0
        tested = int(counters[C_TESTED])
        rec = {
            "metric": "ler_sweep",
            "algorithm": args.algorithm,
            "osd": args.osd,
            "relay": args.relay,
            "weight": w,
            "p": args.p,
            "max_iters": args.iters,
            "tested": tested,
            "corrected_frac": round(counters[C_CORRECTED] / tested, 5),
            "logical_frac": round(counters[C_LOGICAL] / tested, 5),
            "syndrome_fail_frac": round(
                (counters[C_SYN_X] + counters[C_SYN_Z]) / tested, 5),
            "convergence_fail_frac": round(
                (counters[C_CONV_X] + counters[C_CONV_Z]) / tested, 5),
            "samples_per_s": round(tested / secs, 1),
            "bp_iters_total": int(bp_iters),
        }
        ref = reference_fractions(args.code, w, args.iters, args.ref_label_p)
        if ref is not None:
            rec["ref_corrected_frac"] = round(ref[0], 5)
            rec["ref_logical_frac"] = round(ref[1], 5)
            rec["ref_tested"] = ref[2]
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
