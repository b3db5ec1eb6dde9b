"""Relay / ensemble BP: randomized damped retries for BP failures, on device.

The fully device-resident alternative to OSD post-processing (decoder/osd.py):
when min-sum's hard decision violates the syndrome, re-run the decode with
RANDOM PER-VARIABLE DAMPING (memory) coefficients — each retry blends
``v = gamma_v * v_old + (1 - gamma_v) * v_new`` with fresh ``gamma_v`` draws.
Damping disorder breaks the trapping-set symmetries that pin flooding BP, so
different retries escape different traps; a lane is done as soon as any
retry's hard decision satisfies the syndrome.  (Ensemble/memory-BP decoders
of this family are reported to match or beat BP+OSD on quantum LDPC codes —
see PAPERS.md, arXiv:2507.00254 — and unlike OSD the whole thing is batched
device arithmetic: no host round-trip, no Gaussian elimination.)

The DISORDER is the mechanism, not the damping: measured on weight-5
failures of the P=7 code (16 retries, 3 seeds), scalar damping repairs
almost nothing (γ≡0.5: 6/1143 failures; γ≡0.9: 0) while random per-variable
draws repair ~84% — with the range mattering only mildly.  Re-tuned on the
codes that matter (r4, benchmarks/data/relay_tuning_r4.jsonl — [[610,61]]
W∈{40,50} prior 0.02 and BB [[144,12,12]] p∈{0.02,0.03}, 7 ranges × 3
seeds): the WIDEST range γ ~ U[0.05, 1.0) wins on every workload where
failures exist (W=40 repair 0.737 vs 0.703 for the old [0.2, 0.95);
W=50 0.405 vs 0.381; BB p=0.03 0.972 vs 0.963) — more disorder breaks
more traps — so it is the default below.

Unlike OSD, a relay repair is a genuine BP fixed point — typically the
low-weight coset representative — so repaired lanes convert into CORRECTED
outcomes at a much higher rate than OSD's anything-that-satisfies-the-
syndrome solutions.

Implementation notes: retries run under ``lax.while_loop`` with the full
batch resident; already-solved lanes have their syndromes masked to zero,
which makes them converge at the first convergence check.  Everything is
static shapes; the retry counter is the only dynamic state.  Each retry is
one ``min_sum_run(damping=...)``, and every repair is gated by an exact
syndrome re-encode.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from qec_ldpc.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    decode_batch,
)
from qec_ldpc.decoder.min_sum import min_sum_run
from qec_ldpc.decoder.sum_product import BPConfig

#: default damping-draw range gamma ~ U[GAMMA_LOW, GAMMA_HIGH) — tuned in r4
#: (relay_tuning_r4.jsonl; widest range wins on every measured workload).
#: Callers that persist resumable journals must fold the range they use into
#: the journal run_id: retry streams drawn from different ranges must never
#: blend under one id (advisor r4 — the r3->r4 default change was invisible
#: to ``relay=N``-only run_ids).
GAMMA_LOW = 0.05
GAMMA_HIGH = 1.0


def _relay_one_graph(graph, syndrome, prior_llr_p, cfg: BPConfig, key,
                     decisions0, solved0, retries: int,
                     gamma_low: float, gamma_high: float,
                     gamma_lanes: int | None = None, lane_offset=0):
    """Retry loop for one graph.  decisions0/solved0: the primary decode's
    hard decisions and per-lane syndrome-satisfied mask.  Returns (decisions,
    solved, retries_used, extra_lane_iters) — extra_lane_iters counts the
    retries' executed BP lane-iterations (iterations x batch per retry; the
    XLA loop runs every lane until its global exit), keeping the honest-work
    accounting of DecodeResult.iter_samples_* intact in relay mode.

    ``gamma_lanes``/``lane_offset``: when a caller decodes a column slice of
    a larger logical batch (the shard_map'd quality chunk), the damping
    draws come from the FULL ``gamma_lanes``-wide uniform and this shard's
    columns are sliced out — making each lane's retry trajectory independent
    of the batch partition (counter bit-parity across mesh shapes)."""
    batch = syndrome.shape[-1]

    def cond(state):
        r, _, solved, _ = state
        return (r < retries) & ~jnp.all(solved)

    def body(state):
        r, decisions, solved, lane_iters = state
        rk = jax.random.fold_in(key, r)
        if gamma_lanes is None:
            gamma = jax.random.uniform(
                rk, (graph.num_vars, batch), jnp.float32,
                gamma_low, gamma_high)
        else:
            gamma_full = jax.random.uniform(
                rk, (graph.num_vars, gamma_lanes), jnp.float32,
                gamma_low, gamma_high)
            gamma = jax.lax.dynamic_slice_in_dim(
                gamma_full, lane_offset, batch, axis=1)
        damping = graph.expand_vars(gamma)
        # solved lanes: zero syndrome -> trivially converged at first check
        s_eff = jnp.where(solved[None, :], 0, syndrome)
        v, iters = min_sum_run(graph, s_eff, prior_llr_p,
                               max_iters=cfg.max_iters,
                               check_every=cfg.check_every,
                               conv_low=cfg.conv_low,
                               alpha=cfg.min_sum_alpha,
                               damping=damping)
        extra = iters * jnp.int32(batch)
        vv = graph.vn_view(graph.to_var(v))
        d_new = jnp.any(vv <= 0.0, axis=0).astype(decisions.dtype)
        s_hat = graph.syndrome(d_new.astype(jnp.int32))
        sat = ~jnp.any(s_hat != syndrome, axis=0)
        newly = sat & ~solved
        decisions = jnp.where(newly[None, :], d_new, decisions)
        return (r + 1, decisions, solved | newly, lane_iters + extra)

    r_used, decisions, solved, lane_iters = jax.lax.while_loop(
        cond, body, (jnp.int32(0), decisions0, solved0, jnp.int32(0)))
    return decisions, solved, r_used, lane_iters


# gamma_low/high are TRACED (uniform minval/maxval accept tracers), so a
# damping-range sweep (benchmarks/relay_tuning.py) reuses ONE compilation
@partial(jax.jit, static_argnames=("graphs", "cfg", "retries", "gamma_lanes"))
def relay_decode_batch(
    graphs: CodeGraphs,
    syndrome_x: jnp.ndarray,
    syndrome_z: jnp.ndarray,
    error_probability,
    key: jax.Array,
    cfg: BPConfig = BPConfig(),
    retries: int = 8,
    gamma_low: float = GAMMA_LOW,
    gamma_high: float = GAMMA_HIGH,
    gamma_lanes: int | None = None,
    lane_offset=0,
):
    """Primary decode (cfg as configured) + relay
    retries for failed lanes.  Returns the primary DecodeResult with
    decisions/error_code overwritten where a retry repaired the lane, plus
    per-graph retry counts: ``(result, retries_x, retries_z)``.

    SYNDROME_FAIL bits are cleared on repaired lanes; convergence-fail bits
    keep their reference meaning from the primary decode.  The retries'
    executed lane-iterations are added to ``iter_samples_x/z``, so work
    accounting stays honest under relay.
    """
    res = decode_batch(graphs, syndrome_x, syndrome_z, error_probability, cfg)
    prior = jnp.float32(cfg.prior_factor) * jnp.asarray(error_probability,
                                                        jnp.float32)
    kx, kz = jax.random.split(key)
    ec = res.error_code
    out = {}
    for name, bit, graph, syn, dec, k in (
        ("x", SYNDROME_FAIL_X, graphs.x, syndrome_x, res.decisions_x, kx),
        ("z", SYNDROME_FAIL_Z, graphs.z, syndrome_z, res.decisions_z, kz),
    ):
        solved0 = (ec & bit) == 0
        d, solved, r_used, lane_iters = _relay_one_graph(
            graph, syn, prior, cfg, k, dec, solved0, retries,
            gamma_low, gamma_high, gamma_lanes, lane_offset)
        ec = jnp.where(solved, ec & ~bit, ec)
        out[name] = (d, r_used, lane_iters)
    result = dataclasses.replace(
        res, decisions_x=out["x"][0], decisions_z=out["z"][0], error_code=ec,
        iter_samples_x=res.iter_samples_x + out["x"][2],
        iter_samples_z=res.iter_samples_z + out["z"][2])
    return result, out["x"][1], out["z"][1]
