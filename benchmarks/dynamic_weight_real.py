"""Dynamic-weight sweep win, measured on the device.

The r4 feature: ``sample_weight_w_errors_dynamic`` + ``weight_cap`` make the
weight a RUNTIME value, so a whole w..W sweep shares ONE compiled program —
the reference's own experiment shape (``main.cu:91-104`` sweeps w..W per
run) recompiled nothing because it had no compiler; our sweep would
otherwise compile one program per weight.

This artifact pins three things on the device:

* compile accounting: program (trace+compile) counts and wall seconds for
  the full W=1..58 [[610,61]] sweep in dynamic mode vs the first
  ``per_weight_probe`` weights of static mode — the per-weight mode's cost
  is linear in weights, the dynamic mode's is one program;
* counter parity: at every probed weight the dynamic sweep is compared to
  the static-sampler run — the draws differ by design (the dynamic stream
  draws ``weight_cap`` candidates), EXCEPT at ``weight == weight_cap``
  where they are bit-identical (asserted);
* sweep throughput: samples/s over the whole 58-weight sweep.

Usage (on the GPU):
    python -m benchmarks.dynamic_weight_real [out.jsonl]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from benchmarks.common import setup_jax_cache

PER_WEIGHT_PROBE = (1, 15, 30, 58)  # static-mode weights (each = 1 program)
W_MAX = 58
COUNT = 10240


def main(out_path: str = "benchmarks/data/dynamic_weight_real_r5.jsonl") -> int:
    setup_jax_cache()
    import jax

    from qec_ldpc.codes import construct_code
    from qec_ldpc.decoder import BPConfig, CodeGraphs
    from qec_ldpc.parallel import run_monte_carlo

    code = construct_code(4, 5, 10, 61, 9, 49)
    graphs = CodeGraphs.build(code)
    cfg = BPConfig(max_iters=100)
    batch = 2048
    # cap = the sweep's top weight, so the W=58 probe exercises the
    # bit-identical-draws invariant (weight == weight_cap)
    wcap = W_MAX

    records = []

    # ---- dynamic mode: ONE program for the whole sweep ----
    t0 = time.perf_counter()
    dyn_counters = {}
    first_w_seconds = None
    for w in range(1, W_MAX + 1):
        tw = time.perf_counter()
        counters, _ = run_monte_carlo(
            graphs, w, COUNT, 0.01, cfg, seed=500 + w, batch_size=batch,
            steps_per_call=8, weight_cap=wcap)
        dyn_counters[w] = np.asarray(counters)
        if first_w_seconds is None:
            first_w_seconds = time.perf_counter() - tw
    dyn_total = time.perf_counter() - t0
    records.append({
        "mode": "dynamic", "weights": W_MAX, "count_per_weight": COUNT,
        "weight_cap": wcap,
        "total_seconds": round(dyn_total, 2),
        "first_weight_seconds": round(first_w_seconds, 2),
        "steady_weight_seconds": round(
            (dyn_total - first_w_seconds) / (W_MAX - 1), 3),
        "samples_per_s_sweep": round(W_MAX * COUNT / dyn_total, 1),
        "compiled_programs": 1,
        "note": ("one compiled program for all 58 weights: every weight "
                 "after the first pays zero compile/load (the first-weight "
                 "wall includes the single trace+compile+load)"),
    })
    print(f"dynamic: {W_MAX} weights in {dyn_total:.1f}s "
          f"(first {first_w_seconds:.1f}s, steady "
          f"{records[-1]['steady_weight_seconds']}s/weight)", flush=True)

    # ---- static mode: one program PER weight (probe a few) ----
    stat_seconds = {}
    for w in PER_WEIGHT_PROBE:
        tw = time.perf_counter()
        counters, _ = run_monte_carlo(
            graphs, w, COUNT, 0.01, cfg, seed=500 + w, batch_size=batch,
            steps_per_call=8)
        stat_seconds[w] = time.perf_counter() - tw
        static = np.asarray(counters)
        rec = {
            "mode": "static_probe", "weight": w,
            "seconds_incl_compile": round(stat_seconds[w], 2),
            "counters_static": static.tolist(),
            "counters_dynamic": dyn_counters[w].tolist(),
            "tested_equal": bool(static[0] == dyn_counters[w][0]),
            "bit_identical_draws": w == wcap,
        }
        # at w == wcap the dynamic draws are bit-identical to static
        if w == wcap:
            assert np.array_equal(static, dyn_counters[w]), (static,
                                                             dyn_counters[w])
            rec["counters_bit_equal"] = True
        records.append(rec)
        print(f"static W={w}: {stat_seconds[w]:.1f}s "
              f"(fresh program each)", flush=True)

    per_weight_mean = float(np.mean([stat_seconds[w]
                                     for w in PER_WEIGHT_PROBE[1:]]))
    records.append({
        "mode": "summary",
        "static_seconds_per_weight_mean": round(per_weight_mean, 2),
        "static_projected_58_weights": round(per_weight_mean * W_MAX, 1),
        "dynamic_58_weights": round(dyn_total, 1),
        "sweep_speedup": round(per_weight_mean * W_MAX / dyn_total, 1),
    })
    print(f"projected static 58-weight sweep {per_weight_mean * W_MAX:.0f}s "
          f"vs dynamic {dyn_total:.0f}s -> "
          f"{per_weight_mean * W_MAX / dyn_total:.1f}x", flush=True)

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        meta = {"artifact": "dynamic_weight_real",
                "code": str(code),
                "device_kind": jax.devices()[0].device_kind,
                "note": ("the reference's own w..W sweep loop "
                         "(main.cu:91-104) amortized: weight rides as a "
                         "runtime operand of one compiled program "
                         "(sampling.sample_weight_w_errors_dynamic + "
                         "montecarlo weight_cap); static-mode probes "
                         "compile one program per weight for comparison")}
        f.write(json.dumps(meta) + "\n")
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
