"""Smoke test of the Monte-Carlo decode path on the GPU, through the entry
points a user calls, at the reference's full width.

One card (the default) runs every phase below; ``--chips 4`` runs only the
four-card mesh path and what it is compared with.  Each phase prints one
line (``phase <name> ok|FAIL {...}``); the card's name and power limit come
on the line before the last, and the last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase makes the exit code non-zero and the ``ok`` line is not
printed.  Without a GPU the script exits non-zero at once; it never falls
back to the CPU (the CPU backend of the same process is only the reference
the GPU engines are compared with).

Phases (one card):
  device  devices, device kind, card name and power limit
  agree   GPU vs CPU engines on [[610,61]] at batch 512, lane by lane, for
          sum-product, min-sum and layered min-sum (same keys both sides)
  headline  run_monte_carlo on [[610,61]], W=15, p=0.01, MAX=100, 1 048 576
          samples per algorithm: samples/s, compile time kept apart,
          executed and useful lane-iterations, the reference-parity gate
  cli     the reference's literal experiment (100 000 samples) through
          harness.cli.run_sweep, in this process, writing the
          reference-format results file
  beyond  [[144,12,12]] min-sum at depolarizing p=0.01; a P >= 1051 QC code
          with min-sum; quality mode (layered + relay 12 + OSD-0) at W=40

Usage:
    python chip_smoke.py [--out DIR]
    python chip_smoke.py --chips 4 [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from bench import REFERENCE_CORRECTED_FRACTION, card_name_and_power_limit, parity_ok
from qec_ldpc import native
from qec_ldpc.codes import construct_code, find_code_params, known_bicycle_code
from qec_ldpc.decoder import (
    BPConfig,
    CodeGraphs,
    bp_run,
    decode_batch,
    layered_min_sum_run,
    min_sum_run,
)
from qec_ldpc.decoder.decode import syndromes_from_errors
from qec_ldpc.harness.cli import enable_persistent_compile_cache, run_sweep
from qec_ldpc.harness.config import RunConfig
from qec_ldpc.parallel import make_mesh, run_monte_carlo, run_monte_carlo_osd
from qec_ldpc.sampling import (
    classify_batch,
    make_rank_basis_test,
    sample_depolarizing_errors,
    sample_weight_w_errors,
)
from qec_ldpc.sampling.classify import (
    C_CORRECTED,
    C_LOGICAL,
    C_SYN_X,
    C_SYN_Z,
    C_TESTED,
)

ALGORITHMS = ("sum-product", "min-sum", "layered-min-sum")
#: the reference's flagship code and headline workload
QC610 = (4, 5, 10, 61, 9, 49)
MAX_ITERS = 100
#: share of lanes whose sum-product decisions may differ between the GPU
#: and the CPU backend (transcendentals in the priors, FMA contraction and
#: reduction order differ in the last bits; min-sum and layered compare
#: signs and minima and must agree exactly)
SUM_PRODUCT_LANE_TOLERANCE = 1e-3


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def counters_agree(a: np.ndarray, b: np.ndarray, tested: int) -> bool:
    """Two counter vectors over the same ``tested`` lanes agree within a
    4-sigma binomial band per counter (plus one count)."""
    for x, y in zip(a[1:], b[1:]):
        f = max(x, y) / tested
        if abs(int(x) - int(y)) > 4 * (2 * f * (1 - f) * tested) ** 0.5 + 1:
            return False
    return True


# ---- engine agreement ------------------------------------------------------

@contextlib.contextmanager
def outside_compile_cache(device):
    """Keep CPU executables out of the persistent compile cache: XLA:CPU
    code is built for the host's instruction set, and a cache directory
    may be carried to another host."""
    if device.platform != "cpu":
        yield
        return
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    try:
        yield
    finally:
        jax.config.update(key, old)


def decode_on(device, graphs, cfg, key, batch, weight=None, p=0.01,
              error_model="weight"):
    """Sample, decode and classify one batch with every operand on
    ``device``.  Returns host arrays (xe, decisions_x, decisions_z,
    error_code, counters)."""
    code = graphs.code
    test = jax.device_put(make_rank_basis_test(code), device)
    with jax.default_device(device), outside_compile_cache(device):
        key = jax.device_put(key, device)
        if error_model == "weight":
            xe, ze = sample_weight_w_errors(key, code.n, weight, batch)
        else:
            xe, ze = sample_depolarizing_errors(key, code.n, p, batch)
        xe, ze = xe.astype(jnp.int32), ze.astype(jnp.int32)
        sx, sz = syndromes_from_errors(graphs, xe, ze)
        res = decode_batch(graphs, sx, sz, jnp.float32(p), cfg)
        counters = classify_batch(test, xe, ze,
                                  res.decisions_x.astype(jnp.int32),
                                  res.decisions_z.astype(jnp.int32),
                                  res.error_code)
    return tuple(np.asarray(a) for a in (xe, res.decisions_x, res.decisions_z,
                                         res.error_code, counters))


def compare_engines(graphs, cfg, devices, batch, seed=0, weight=None, p=0.01,
                    error_model="weight", exact=None):
    """Lane-by-lane comparison of ``decode_batch`` on two devices (the
    accelerator and the CPU reference) with the same keys.  ``exact``
    defaults to True for min-sum and layered, whose decisions and error
    codes must be identical; sum-product may differ on at most
    SUM_PRODUCT_LANE_TOLERANCE of the lanes.  Returns a summary dict and
    raises PhaseFailed past the tolerance."""
    if exact is None:
        exact = cfg.algorithm != "sum-product"
    key = jax.random.PRNGKey(seed)
    a, b = (decode_on(d, graphs, cfg, key, batch, weight, p, error_model)
            for d in devices)
    check(np.array_equal(a[0], b[0]), "sampled errors differ between devices")
    differ = ~(np.all(a[1] == b[1], axis=0) & np.all(a[2] == b[2], axis=0)
               & (a[3] == b[3]))
    lanes = np.nonzero(differ)[0].tolist()
    for lane in lanes:
        print(f"  {cfg.algorithm}: lane {lane} differs: error code "
              f"{int(a[3][lane])} vs {int(b[3][lane])}, decision bits "
              f"{int((a[1][:, lane] != b[1][:, lane]).sum())} X / "
              f"{int((a[2][:, lane] != b[2][:, lane]).sum())} Z")
    share = len(lanes) / batch
    summary = {"algorithm": cfg.algorithm, "lanes": batch,
               "differing_lanes": len(lanes), "differing_share": share,
               "counters": a[4].tolist(), "reference_counters": b[4].tolist()}
    check(share == 0 if exact else share <= SUM_PRODUCT_LANE_TOLERANCE,
          f"{cfg.algorithm}: {len(lanes)} of {batch} lanes differ")
    check(counters_agree(a[4], b[4], batch),
          f"{cfg.algorithm}: counters outside the 4-sigma band")
    return summary


def phase_agree(graphs, devices, batch=512, weight=15):
    return [compare_engines(graphs, BPConfig(max_iters=MAX_ITERS,
                                             algorithm=algo),
                            devices, batch, weight=weight)
            for algo in ALGORITHMS]


# ---- headline ----------------------------------------------------------------

@partial(jax.jit, static_argnames=("graphs", "cfg"))
def per_lane_iterations(graphs, syndrome_x, syndrome_z, error_probability,
                        cfg):
    """(batch,) X + Z iterations each lane needs when it exits on its own:
    the useful work of a batched decode, which runs every lane until the
    whole batch has converged.  vmap gives each lane its own while_loop
    trip count."""
    prior = jnp.float32(cfg.prior_factor) * jnp.float32(error_probability)

    def lane(graph, s):
        s = s[:, None]
        if cfg.algorithm == "layered-min-sum":
            return layered_min_sum_run(
                graph, s, prior, max_iters=cfg.max_iters,
                check_every=cfg.layered_check_every,
                alpha=cfg.min_sum_alpha)[1]
        if cfg.algorithm == "min-sum":
            return min_sum_run(
                graph, s, prior, max_iters=cfg.max_iters,
                check_every=cfg.check_every, conv_low=cfg.conv_low,
                alpha=cfg.min_sum_alpha)[1]
        return bp_run(graph, s, prior, max_iters=cfg.max_iters,
                      check_every=cfg.check_every, conv_low=cfg.conv_low,
                      conv_high=cfg.conv_high)[1]

    nx = jax.vmap(partial(lane, graphs.x), in_axes=1)(syndrome_x)
    nz = jax.vmap(partial(lane, graphs.z), in_axes=1)(syndrome_z)
    return nx + nz


def useful_iterations_per_sample(graphs, cfg, weight, p, batch, seed=123):
    key = jax.random.PRNGKey(seed)
    xe, ze = sample_weight_w_errors(key, graphs.code.n, weight, batch)
    sx, sz = syndromes_from_errors(graphs, xe.astype(jnp.int32),
                                   ze.astype(jnp.int32))
    n = per_lane_iterations(graphs, sx, sz, jnp.float32(p), cfg)
    return float(np.asarray(n).mean())


def headline_run(graphs, cfg, weight, p, count, batch, repeats=2,
                 useful_batch=8192, mesh=None, seed=1):
    """run_monte_carlo timed: the first call compiles, the best of
    ``repeats`` steady calls gives the rate.  One dispatch per run."""
    spc = -(-count // batch)

    def run():
        return run_monte_carlo(graphs, weight, count, p, cfg, seed=seed,
                               batch_size=batch, steps_per_call=spc,
                               mesh=mesh)

    t0 = time.perf_counter()
    counters, lane_iters = run()
    first = time.perf_counter() - t0
    steady = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        counters, lane_iters = run()
        steady.append(time.perf_counter() - t0)
    tested = int(counters[C_TESTED])
    out = {
        "algorithm": cfg.algorithm, "samples": tested,
        "corrected_fraction": int(counters[C_CORRECTED]) / tested,
        "samples_per_s": tested / min(steady),
        "steady_s": steady, "first_call_s": first,
        "compile_s": max(first - min(steady), 0.0),
        "executed_bp_lane_iters": int(lane_iters),
        "executed_per_sample": int(lane_iters) / tested,
        "counters": counters.tolist(),
    }
    if useful_batch:
        useful = useful_iterations_per_sample(graphs, cfg, weight, p,
                                              useful_batch)
        out["useful_per_sample"] = useful
        out["useful_share"] = useful / out["executed_per_sample"]
    return out


def phase_headline(graphs, count=1 << 20, batch=2048, useful_batch=8192):
    results = []
    for algo in ALGORITHMS:
        cfg = BPConfig(max_iters=MAX_ITERS, algorithm=algo)
        r = headline_run(graphs, cfg, 15, 0.01, count, batch,
                         useful_batch=useful_batch)
        check(r["samples"] >= count, f"{algo}: {r['samples']} < {count}")
        c = r["counters"]
        if algo == "sum-product":
            r["parity"] = parity_ok(c[C_CORRECTED], c[C_TESTED])
            check(r["parity"], f"sum-product corrected fraction "
                  f"{r['corrected_fraction']} fails the parity gate")
        elif algo == "layered-min-sum":
            sigma = (REFERENCE_CORRECTED_FRACTION
                     * (1 - REFERENCE_CORRECTED_FRACTION) / c[C_TESTED]) ** .5
            r["parity"] = (r["corrected_fraction"]
                           >= REFERENCE_CORRECTED_FRACTION - 4 * sigma)
            check(r["parity"], f"layered corrected fraction "
                  f"{r['corrected_fraction']} below the reference")
        results.append(r)
    return results


# ---- the reference's literal experiment through the CLI ----------------------

def phase_cli(out_dir, code_spec="qc:4,5,10,61,9,49", count=100_000,
              weight=15, seed=2287037912):
    """The reference's init.txt (code610, W=15, COUNT=100000, MAX=100,
    p=0.01) as a RunConfig through run_sweep; the results file it writes
    must agree with the run and pass the parity gate."""
    from qec_ldpc.harness.config import format_result_filename
    from qec_ldpc.harness.stats import parse_reference_text

    cfg = RunConfig(code_file=code_spec, weight_start=weight,
                    weight_end=weight, count=count,
                    max_iterations=MAX_ITERS, error_probability=0.01,
                    seed=seed, results_dir=out_dir,
                    log_file=f"{out_dir}/output_log.txt")
    t0 = time.perf_counter()
    (stats,) = run_sweep(cfg)
    wall = time.perf_counter() - t0
    path = (f"{out_dir}/"
            + format_result_filename(stats.code_str, weight, MAX_ITERS, 0.01))
    with open(path) as f:
        record = parse_reference_text(f.read())[-1]
    check(int(record["Corrected"]) == stats.corrected,
          "results file disagrees with the run")
    check(stats.num_errors_tested >= count, "too few samples tested")
    ok = parity_ok(stats.corrected, stats.num_errors_tested)
    check(ok, f"CLI corrected fraction "
          f"{stats.corrected / stats.num_errors_tested} fails the parity gate")
    return {"results_file": path, "samples": stats.num_errors_tested,
            "corrected": stats.corrected,
            "corrected_fraction": stats.corrected / stats.num_errors_tested,
            "wall_s": wall, "duration_us": stats.duration_micro_seconds,
            "parity": ok}


# ---- beyond the reference ------------------------------------------------------

def phase_bicycle(devices, count=64 * 2048, batch=2048, agree_batch=512):
    graphs = known_bicycle_code("[[144,12,12]]").build_graphs()
    cfg = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    agree = compare_engines(graphs, cfg, devices, agree_batch,
                            error_model="depolarizing", p=0.01)
    counters, _ = run_monte_carlo(graphs, 0, count, 0.01, cfg, seed=1,
                                  batch_size=batch,
                                  error_model="depolarizing",
                                  steps_per_call=-(-count // batch))
    frac = int(counters[C_CORRECTED]) / int(counters[C_TESTED])
    check(frac > 0.99, f"[[144,12,12]] corrected fraction {frac}")
    return {"code": "[[144,12,12]]", "agree": agree,
            "corrected_fraction": frac, "samples": int(counters[C_TESTED])}


def phase_large_p(devices, P=1051, weight=15, count=16 * 512, batch=512,
                  agree_batch=64):
    sigma, tau = find_code_params(4, 5, 10, P)[0]
    graphs = CodeGraphs.build(construct_code(4, 5, 10, P, sigma, tau))
    cfg = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    agree = compare_engines(graphs, cfg, devices, agree_batch, weight=weight)
    t0 = time.perf_counter()
    counters, _ = run_monte_carlo(graphs, weight, count, 0.01, cfg, seed=1,
                                  batch_size=batch,
                                  steps_per_call=-(-count // batch))
    wall = time.perf_counter() - t0
    frac = int(counters[C_CORRECTED]) / int(counters[C_TESTED])
    check(frac > 0.99, f"P={P} corrected fraction {frac}")
    return {"code": str(graphs.code), "agree": agree, "corrected_fraction": frac,
            "samples": int(counters[C_TESTED]), "wall_s_incl_compile": wall}


def phase_quality(graphs, weight=40, p=0.02, chunks=4, batch=2048):
    cfg = BPConfig(max_iters=MAX_ITERS, algorithm="layered-min-sum")
    count = chunks * batch
    t0 = time.perf_counter()
    counters, _ = run_monte_carlo_osd(graphs, weight, count, p, cfg, seed=5,
                                      batch_size=batch, lam=0,
                                      relay_retries=12)
    wall = time.perf_counter() - t0
    check(int(counters[C_TESTED]) == count, "quality mode lost samples")
    check(counters[C_SYN_X] == 0 and counters[C_SYN_Z] == 0,
          "OSD-0 left syndrome failures")
    check(counters[C_CORRECTED] + counters[C_LOGICAL] == counters[C_TESTED],
          "quality counters do not partition the samples")
    return {"weight": weight, "samples": count,
            "corrected_fraction": int(counters[C_CORRECTED]) / count,
            "have_native": native.native_available(),
            "wall_s_incl_compile": wall}


def phase_beyond(graphs610, devices):
    return {"bicycle": phase_bicycle(devices),
            "large_p": phase_large_p(devices),
            "quality": phase_quality(graphs610)}


# ---- four cards ----------------------------------------------------------------

def phase_four_card(graphs, devices, count=1 << 20, batch=4 * 2048,
                    graph_count=1 << 16, graph_batch=2048, weight=15):
    """Data-parallel headline on a 4-card data mesh (parity-gated), and a
    data x graph 2 x 2 min-sum run whose counters must bit-match a data=2,
    graph=1 mesh at the same seed."""
    check(len(devices) >= 4, f"need 4 devices, have {len(devices)}")
    sp = BPConfig(max_iters=MAX_ITERS)
    head = headline_run(graphs, sp, weight, 0.01, count, batch, useful_batch=0,
                        mesh=make_mesh(num_data=4, devices=devices[:4]))
    c = head["counters"]
    head["parity"] = parity_ok(c[C_CORRECTED], c[C_TESTED])
    check(head["parity"], f"4-card corrected fraction "
          f"{head['corrected_fraction']} fails the parity gate")
    ms = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    runs = {}
    for name, mesh in (("data2_graph2", make_mesh(2, 2, devices[:4])),
                       ("data2_graph1", make_mesh(2, 1, devices[:2]))):
        t0 = time.perf_counter()
        counters, iters = run_monte_carlo(graphs, weight, graph_count, 0.01, ms,
                                          seed=3, batch_size=graph_batch,
                                          mesh=mesh)
        runs[name] = {"counters": counters.tolist(), "lane_iters": iters,
                      "wall_s_incl_compile": time.perf_counter() - t0}
    check(runs["data2_graph2"]["counters"] == runs["data2_graph1"]["counters"],
          "graph-sharded counters differ from the data-only mesh")
    return {"data_parallel_headline": head, "graph_sharded": runs}


# ---- main --------------------------------------------------------------------

def run_phase(name, fn, results):
    """Run one phase; a failure is reported and the remaining phases still
    run, so one call shows every fault."""
    t0 = time.perf_counter()
    try:
        info = fn()
    except PhaseFailed as e:
        results[name] = False
        print(f"phase {name} FAIL {e}", flush=True)
        return
    except Exception:  # noqa: BLE001 — reported, and fails the run
        results[name] = False
        traceback.print_exc()
        print(f"phase {name} FAIL (exception above)", flush=True)
        return
    results[name] = True
    print(f"phase {name} ok {time.perf_counter() - t0:.1f}s "
          f"{json.dumps(info, default=str)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card mesh path")
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for the CLI phase's results files")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    # keep the CPU backend beside the accelerator: it is the reference the
    # GPU engines are compared with
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              f"refusing to run on the CPU", file=sys.stderr)
        return 2
    enable_persistent_compile_cache()
    cpu = jax.devices("cpu")[0]
    results: dict[str, bool] = {}

    run_phase("device", lambda: {
        "devices": [str(d) for d in devices],
        "kind": devices[0].device_kind, "count": len(devices)}, results)
    graphs610 = CodeGraphs.build(construct_code(*QC610))
    if args.chips == 4:
        run_phase("four_card", lambda: phase_four_card(graphs610, devices),
                  results)
    else:
        run_phase("agree", lambda: phase_agree(graphs610, (devices[0], cpu)),
                  results)
        run_phase("headline", lambda: phase_headline(graphs610), results)
        run_phase("cli", lambda: phase_cli(f"{args.out}/cli"), results)
        run_phase("beyond",
                  lambda: phase_beyond(graphs610, (devices[0], cpu)), results)
    print(f"elapsed {time.perf_counter() - t_start:.1f}s", flush=True)
    print(f"card: {card_name_and_power_limit()}", flush=True)
    if not all(results.values()):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
