"""Headline benchmark: the reference's own headline workload on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Headline metric: **samples decoded per second** on the reference's headline
benchmark workload — the [[610,61]] code at W=15, p=0.01, MAX_ITERATIONS=100,
convergence checked every 10 iterations with early exit, full Monte-Carlo
pipeline (sample weight-15 Pauli errors -> X/Z syndromes -> batched
sum-product decode -> classify -> counters).
This is apples-to-apples with the reference's own number: its CPU+OpenMP
harness decoded 100 000 such samples in 112.73 s = 887 samples/s, *with* the
same per-sample early exit (BP breaks on convergence, DecoderCPU.h:282,287),
per results/[J=4,K=5,L=10,P=61,s=9,t=49][[n=610,k=61]]_W_15_MAX_100_p_0.01.txt
(SURVEY §6).  Statistical parity is asserted in the same run: the corrected
fraction must match the reference's 0.99539 within Monte-Carlo noise.
Prior provenance (r4, benchmarks/data/golden_deep_r4.jsonl): unlike the
W>=20 subdir corpus (generated at prior 0.02), the 100k-sample W=15
HEADLINE file matches prior 0.01 exactly (1M-sample z=+0.27 at 0.01 vs
+10.2 at 0.02) — so this benchmark's 0.01 decode against its 0.99539 IS the
apples-to-apples comparison.

Secondary fields (same JSON line): fixed-work BP-iteration throughput — the
north-star metric of BASELINE.json (>=1e6 BP-iteration*codewords/s/chip) —
measured with the convergence exit disabled so every lane executes exactly
100 X- and 100 Z-iterations (verified per chunk), iteration*samples counted
per sample exactly as the baseline derivation (887 samples/s x <=100 iters
<= 8.87e4 iter*samples/s for the whole reference machine).

Methodology: chunks are scanned on device inside one dispatch (the
production path amortizes identically, parallel/montecarlo.py
steps_per_call); the early-exit runs time 1 048 576 samples and the parity
counters come from the same runs.  Every timed region ends in a host read
of the counters or ``block_until_ready``.  The first run of each workload
compiles; its excess over the best steady run is reported as compile time.
The card's name and power limit are recorded beside the numbers, and a
device kind missing from :data:`PEAKS` is an error.
"""

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_SAMPLES_PER_S = 887.0       # reference headline, SURVEY §6
BASELINE_ITER_SAMPLES_PER_S = 8.87e4  # derived: 887 samples/s x <=100 iters
REFERENCE_CORRECTED_FRACTION = 0.99539  # 99539 / 100000, same results file
BASELINE_SMALL_CODE_SAMPLES_PER_S = 110_000.0  # [[42]] W=1 p=0.02 (BASELINE.md row 4)

#: published peaks per JAX ``device_kind`` (NVIDIA H100 data sheet, SXM
#: part, dense rates at the 700 W limit): f32 outside the tensor cores (the
#: decoders' elementwise f32 arithmetic), bf16 tensor cores, HBM bandwidth
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops_per_s": 67e12,
                              "bf16_flops_per_s": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def parity_ok(corrected: int, tested: int,
              reference: float = REFERENCE_CORRECTED_FRACTION) -> bool:
    """Reference-parity gate: the corrected fraction lies within a binomial
    4-sigma band (plus 1e-4 slack) around the reference's at our count."""
    sigma = (reference * (1 - reference) / tested) ** 0.5
    return abs(corrected / tested - reference) < 4 * sigma + 1e-4


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card(s), one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def bp_flops_per_iter_sample(graphs) -> float:
    """Analytic f32 FLOPs of ONE BP iteration of ONE sample (X + Z graphs),
    flooding sum-product (decoder/sum_product.py).

    Counted by hand from the algorithm, not from XLA's cost analysis, so
    the numerator does not change with how XLA fuses.  Per edge-tensor of E = B*L*P
    edges (B block-rows of degree L; var degree B):

    * CN: t = 1 - 2v (2E); leave-one-out products via prefix/suffix trees,
      ~3 multiplies per edge (3E); e = 0.5 - sgn * other * loo (2E) -> 7E.
    * VN: 1-p terms (E); two leave-one-out trees (p and 1-p), ~3E each (6E);
      posterior num/den/divide (4E) -> 11E.
    * Rolls/permutes move data, 0 FLOPs.

    Total ~18 FLOPs per edge per iteration — a deliberate undercount (no
    convergence-scan, init, syndrome, or masking ops), so the utilization
    figure is conservative.  Each "iteration*sample" of the north-star
    metric executes one X-graph AND one Z-graph iteration (the reference
    decodes both per sample, DecoderCPU.h:329-345).
    """
    def edges(g):
        return g.B * g.L * g.P

    return 18.0 * (edges(graphs.x) + edges(graphs.z))


def _total_edges(graphs) -> int:
    return (graphs.x.B * graphs.x.L * graphs.x.P
            + graphs.z.B * graphs.z.L * graphs.z.P)


def min_sum_flops_per_iter_sample(graphs) -> float:
    """Analytic f32 FLOPs of one flooding min-sum iteration of one sample
    (X + Z), same counting discipline as :func:`bp_flops_per_iter_sample`
    (VERDICT r3 weak #3: the FASTER production paths had no FLOP model).

    Per edge: CN — |t| (1), sign (1), leave-one-out min prefix/suffix tree
    (~3 compares), sign-product tree (~3 mults), e = syn_sign*alpha*loo_sgn*
    loo_min (3) -> 11; VN — leave-one-out sum trees (~3 adds), + prior (1)
    -> 4.  Total ~15/edge/iteration; deliberate undercount (no damping,
    masking, convergence ops), so utilization is conservative.
    """
    return 15.0 * _total_edges(graphs)


def layered_flops_per_sweep_sample(graphs) -> float:
    """Analytic f32 FLOPs of one layered min-sum SWEEP (all B layers) of one
    sample (X + Z).  Per edge per sweep (decoder/layered.py steps 1-3):
    t = to_check(q) - r (1), |t| (1), sign (1), leave-one-out min+sign trees
    (~6), r' = sgn*alpha*loo (3), delta = r' - r (1), q += to_var(delta) (1)
    -> ~14/edge/sweep; same conservative discipline."""
    return 14.0 * _total_edges(graphs)


def measure_reference_rates(jax, jnp) -> dict:
    """What this card reaches on a large plain copy (bytes/s, read + write)
    and a large bf16 matrix product with f32 accumulation (FLOP/s) — the
    practical ceilings beside the published peaks."""
    x = jnp.zeros((1 << 28,), jnp.float32)            # 1 GiB
    a = jnp.ones((8192, 8192), jnp.bfloat16)
    copy = jax.jit(lambda v: v + 1.0)
    mm = jax.jit(lambda m: jnp.dot(m, m, preferred_element_type=jnp.float32))

    def best(fn, arg, reps=5):
        jax.block_until_ready(fn(arg))  # compile + warm up
        t = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(arg))
            t = min(t, time.perf_counter() - t0)
        return t

    return {"copy_bytes_per_s": 2 * x.nbytes / best(copy, x),
            "bf16_matmul_flops_per_s": 2 * 8192 ** 3 / best(mm, a)}


def _timed(fn, repeats: int = 3):
    """(last result, first-call seconds, sorted steady-run seconds): the
    first call compiles; ``fn`` must end in a host read or
    block_until_ready."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    steady = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        steady.append(time.perf_counter() - t0)
    return out, first, sorted(steady)


def main() -> int:
    import jax

    from qec_ldpc.harness.cli import enable_persistent_compile_cache

    dev = jax.devices()[0]
    kind = dev.device_kind
    if kind not in PEAKS:
        raise SystemExit(f"bench.py: no peak table entry for device kind "
                         f"{kind!r} (platform {dev.platform}); add it with "
                         f"its source")
    peaks = PEAKS[kind]
    card = card_name_and_power_limit()
    enable_persistent_compile_cache()

    import jax.numpy as jnp

    from qec_ldpc.codes import construct_code, known_bicycle_code
    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.decoder.decode import CodeGraphs
    from qec_ldpc.parallel.montecarlo import _chunk_body, run_monte_carlo
    from qec_ldpc.sampling import NUM_COUNTERS

    code = construct_code(4, 5, 10, 61, 9, 49)
    graphs = CodeGraphs.build(code)
    max_iters = 100
    batch = 2048
    weight = 15
    i_minus_p = jnp.asarray(code.i_minus_p)
    count = 512 * batch  # 1 048 576 samples, scanned in one dispatch

    def early_exit(cfg):
        return _timed(lambda: run_monte_carlo(
            graphs, weight, count, 0.01, cfg, seed=1, batch_size=batch,
            steps_per_call=512))

    # ---- headline: reference workload, early exit on (check every 10) ----
    (counters, lane_iters), first_ee, ee_times = early_exit(
        BPConfig(max_iters=max_iters, check_every=10))
    tested = int(counters[0])
    corrected_fraction = counters[3] / counters[0]
    assert tested >= count, counters
    assert parity_ok(int(counters[3]), tested), corrected_fraction
    best_ee = ee_times[0]
    samples_per_s = tested / best_ee

    # ---- secondary: layered min-sum (serial block-row schedule) ----
    # converges in ~3 sweeps where flooding needs ~11 iterations, at a
    # BETTER corrected fraction than the reference's sum-product (no parity
    # claim — a different, stronger decoder; gated from below)
    (ly_counters, _), _, ly_times = early_exit(
        BPConfig(max_iters=max_iters, algorithm="layered-min-sum"))
    ly_corrected = ly_counters[3] / ly_counters[0]
    sigma = (REFERENCE_CORRECTED_FRACTION
             * (1 - REFERENCE_CORRECTED_FRACTION) / tested) ** 0.5
    assert ly_corrected >= REFERENCE_CORRECTED_FRACTION - 4 * sigma, ly_corrected
    layered_samples_per_s = int(ly_counters[0]) / ly_times[0]

    # ---- fixed-work BP-iteration throughput (north star), per algorithm ----
    # check_every > max_iters disables the convergence exit after the
    # (vacuous) n=0 check -> fixed work; verified via the iters output
    chunks = 64

    def fixed_work(algorithm):
        cfg = BPConfig(max_iters=max_iters, check_every=max_iters + 1,
                       layered_check_every=max_iters + 1,
                       algorithm=algorithm)

        @jax.jit
        def run(key, i_minus_p):
            def body(carry, c):
                cnt_acc, min_it = carry
                ck = jax.random.fold_in(key, c)
                cnt, iters = _chunk_body(graphs, i_minus_p, ck, weight,
                                         jnp.float32(0.01), cfg, batch,
                                         "weight")
                return (cnt_acc + cnt,
                        jnp.minimum(min_it, jnp.min(iters))), None
            init = (jnp.zeros(NUM_COUNTERS, jnp.int32), jnp.int32(2**31 - 1))
            (cnt, min_it), _ = jax.lax.scan(
                body, init, jnp.arange(chunks, dtype=jnp.uint32))
            return cnt, min_it

        key = jax.random.PRNGKey(0)
        (cnt, min_it), _, times = _timed(
            lambda: jax.block_until_ready(run(key, i_minus_p)))
        # iters are lane-iteration sums: full work = max_iters per lane
        assert int(min_it) == max_iters * batch, (
            f"{algorithm}: early exit leaked: {int(min_it)}")
        assert int(cnt[0]) == chunks * batch, cnt
        return chunks * batch * max_iters / times[0]

    iter_samples_per_s = fixed_work("sum-product")
    ms_iter_per_s = fixed_work("min-sum")
    ly_iter_per_s = fixed_work("layered-min-sum")

    # ---- achieved f32 FLOP/s against the card's peak (fixed-work runs) ----
    # numerator: the analytic FLOP models above; denominators: the
    # published f32 peak and, measured in this run, what a large copy and a
    # large bf16 matmul reach
    achieved_flops = iter_samples_per_s * bp_flops_per_iter_sample(graphs)
    ms_flops = ms_iter_per_s * min_sum_flops_per_iter_sample(graphs)
    ly_flops = ly_iter_per_s * layered_flops_per_sweep_sample(graphs)
    rates = measure_reference_rates(jax, jnp)
    f32_peak = peaks["f32_flops_per_s"]

    # ---- secondary: [[42]] small code — the dispatch-overhead regime ----
    # reference: ~110k samples/s at W=1, MAX=100, p=0.02 (BASELINE.md row 4)
    small_graphs = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    sm_batch = 8192
    sm_cfg = BPConfig(max_iters=max_iters, check_every=10)
    (sm_counters, _), _, sm_times = _timed(lambda: run_monte_carlo(
        small_graphs, 1, 256 * sm_batch, 0.02, sm_cfg, seed=1,
        batch_size=sm_batch, steps_per_call=256))
    sm_corrected = sm_counters[3] / sm_counters[0]
    small_samples_per_s = int(sm_counters[0]) / sm_times[0]

    # ---- secondary: bivariate bicycle gross code (beyond-reference family) --
    # [[144,12,12]] (codes/bicycle.py) decoded with flooding min-sum on the
    # lifted graph, depolarizing p=0.01, early exit — no reference analog,
    # so no parity claim; the gate is a loose sanity bound on the corrected
    # fraction
    bb_graphs = known_bicycle_code("[[144,12,12]]").build_graphs()
    bb_cfg = BPConfig(max_iters=max_iters, algorithm="min-sum")
    (bb_counters, _), _, bb_times = _timed(lambda: run_monte_carlo(
        bb_graphs, 0, 64 * batch, 0.01, bb_cfg, seed=1, batch_size=batch,
        error_model="depolarizing", steps_per_call=64))
    bb_corrected = bb_counters[3] / bb_counters[0]
    assert bb_corrected > 0.99, bb_corrected
    bb_samples_per_s = int(bb_counters[0]) / bb_times[0]

    result = {
        "metric": "samples_per_s_per_chip_reference_headline_workload",
        "value": round(samples_per_s, 1),
        "unit": ("samples/s/chip ([[610,61]], W=15, p=0.01, MAX=100, "
                 "early exit, full pipeline sample+X/Z decode+classify, "
                 "sum-product; reference CPU: 887 samples/s on the "
                 "identical workload)"),
        "vs_baseline": round(samples_per_s / BASELINE_SAMPLES_PER_S, 2),
        "corrected_fraction": round(float(corrected_fraction), 5),
        "reference_corrected_fraction": REFERENCE_CORRECTED_FRACTION,
        "executed_bp_lane_iters_per_s": round(int(lane_iters) / best_ee, 1),
        "layered_min_sum_samples_per_s": round(layered_samples_per_s, 1),
        "layered_min_sum_vs_baseline": round(
            layered_samples_per_s / BASELINE_SAMPLES_PER_S, 2),
        "layered_min_sum_corrected_fraction": round(float(ly_corrected), 5),
        "fixed_work_bp_iter_codewords_per_s_per_chip": round(
            iter_samples_per_s, 1),
        "fixed_work_vs_baseline": round(
            iter_samples_per_s / BASELINE_ITER_SAMPLES_PER_S, 2),
        "achieved_f32_flops_per_s": round(achieved_flops, 1),
        "f32_peak_flops_per_s": f32_peak,
        "f32_peak_share": round(achieved_flops / f32_peak, 4),
        "min_sum_fixed_work_iter_cw_per_s": round(ms_iter_per_s, 1),
        "min_sum_achieved_flops_per_s": round(ms_flops, 1),
        "min_sum_f32_peak_share": round(ms_flops / f32_peak, 4),
        "layered_fixed_work_sweep_cw_per_s": round(ly_iter_per_s, 1),
        "layered_achieved_flops_per_s": round(ly_flops, 1),
        "layered_f32_peak_share": round(ly_flops / f32_peak, 4),
        "measured_copy_bytes_per_s": round(rates["copy_bytes_per_s"], 1),
        "measured_bf16_matmul_flops_per_s": round(
            rates["bf16_matmul_flops_per_s"], 1),
        "device": {"platform": dev.platform, "kind": kind,
                   "count": len(jax.devices())},
        "card_name_and_power_limit": card,
        # compile-phase accounting: the first headline run compiles; with
        # the persistent cache warm the excess over the steady-state time
        # collapses to executable-load time
        "headline_first_dispatch_s": round(first_ee, 2),
        "headline_steady_dispatch_s": round(best_ee, 2),
        "headline_steady_dispatch_spread_s": round(ee_times[-1] - best_ee, 3),
        "headline_compile_phase_s": round(max(first_ee - best_ee, 0.0), 2),
        "small_code_42_samples_per_s": round(small_samples_per_s, 1),
        "small_code_42_vs_baseline": round(
            small_samples_per_s / BASELINE_SMALL_CODE_SAMPLES_PER_S, 2),
        "small_code_42_corrected_fraction": round(float(sm_corrected), 5),
        "bicycle_gross_samples_per_s": round(bb_samples_per_s, 1),
        "bicycle_gross_corrected_fraction": round(float(bb_corrected), 5),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
