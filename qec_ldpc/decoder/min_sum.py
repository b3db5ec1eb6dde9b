"""Batched normalized min-sum BP over a circulant Tanner graph.

Framework-native second decode algorithm (BASELINE config 2: "batched min-sum
BP decode, single chip, fixed 50-iteration cap").  The reference implements
only probability-domain sum-product (``DecoderCPU.h:150-229``); min-sum is the
standard production approximation: log-likelihood-ratio messages, check-node
magnitude replaced by a (normalized) minimum.  LLR convention:

    llr = log(P(no error) / P(error)),  so  p >= 0.5  <=>  llr <= 0.

Rules (per edge, leave-one-out over the check/var neighborhood):
  * CN:  E = alpha * syndrome_sign * prod(sign(V_l')) * min(|V_l'|)
         with syndrome_sign = +1 for syndrome 0, -1 for syndrome 1 — the
         exact min-approximation of the sum-product rule the reference
         computes in probability domain (DecoderCPU.h:153-183).
  * VN:  V = prior_llr + sum(E_b'), excluding the target check unless the
         last iteration (posterior), mirroring DecoderCPU.h:216.

Convergence / hard-decision semantics map the reference's probability-domain
constants through the LLR transform:
  * message p inside (low, 1-low)  <=>  |llr| < log((1-low)/low)
    (CheckConvergence band, DecoderCPU.h:231-246, low=0.01 -> |llr| < ln 99)
  * hard decision "any incident message >= 0.5" (DecoderCPU.h:354-373)
    <=>  any incident llr <= 0.

Same flat (num_edges, batch) check-indexed layout, static-roll routing and
masked early exit as decoder/sum_product.py — jit/vmap/shard_map friendly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from qec_ldpc.decoder.layout import CirculantGraph


def _loo_sums(terms: list[jnp.ndarray]) -> list[jnp.ndarray]:
    """Leave-one-out sums of a small static list (exclusive prefix+suffix)."""
    m = len(terms)
    zeros = jnp.zeros_like(terms[0])
    prefix = [zeros] * m
    for i in range(1, m):
        prefix[i] = prefix[i - 1] + terms[i - 1]
    suffix = [zeros] * m
    for i in range(m - 2, -1, -1):
        suffix[i] = suffix[i + 1] + terms[i + 1]
    return [prefix[i] + suffix[i] for i in range(m)]


def _loo_mins(terms: list[jnp.ndarray]) -> list[jnp.ndarray]:
    """Leave-one-out minima of a small static list."""
    m = len(terms)
    big = jnp.full_like(terms[0], jnp.inf)
    prefix = [big] * m
    for i in range(1, m):
        prefix[i] = jnp.minimum(prefix[i - 1], terms[i - 1])
    suffix = [big] * m
    for i in range(m - 2, -1, -1):
        suffix[i] = jnp.minimum(suffix[i + 1], terms[i + 1])
    return [jnp.minimum(prefix[i], suffix[i]) for i in range(m)]


def _loo_sign_products(signs: list[jnp.ndarray]) -> list[jnp.ndarray]:
    """Leave-one-out products of +-1 sign tensors."""
    m = len(signs)
    ones = jnp.ones_like(signs[0])
    prefix = [ones] * m
    for i in range(1, m):
        prefix[i] = prefix[i - 1] * signs[i - 1]
    suffix = [ones] * m
    for i in range(m - 2, -1, -1):
        suffix[i] = suffix[i + 1] * signs[i + 1]
    return [prefix[i] * suffix[i] for i in range(m)]


def cn_update_min_sum(
    graph: CirculantGraph, v: jnp.ndarray, syndrome_sign: jnp.ndarray,
    alpha: float,
) -> jnp.ndarray:
    """Normalized-min-sum check-node update; v, result check-indexed
    (num_edges, batch) LLRs.  syndrome_sign: per-edge +-1 rows."""
    t = graph.cn_view(v)                       # (B, L, P*batch)
    mags = [jnp.abs(t[:, i]) for i in range(graph.check_degree)]
    sgns = [jnp.where(t[:, i] < 0, -1.0, 1.0) for i in range(graph.check_degree)]
    loo_min = _loo_mins(mags)
    loo_sgn = _loo_sign_products(sgns)
    e = jnp.stack([alpha * loo_sgn[i] * loo_min[i] for i in range(graph.check_degree)],
                  axis=1).reshape(v.shape)
    return syndrome_sign * e


def vn_update_llr(
    graph: CirculantGraph, e: jnp.ndarray, prior_llr: jnp.ndarray | float,
    last: jnp.ndarray,
) -> jnp.ndarray:
    """LLR variable-node update: leave-one-out sums plus the channel prior;
    the last iteration forms full posteriors (DecoderCPU.h:216 semantics)."""
    ev = graph.vn_view(graph.to_var(e))        # (B, L*P, batch) var-indexed
    terms = [ev[i] for i in range(graph.var_degree)]
    loo = _loo_sums(terms)
    full = loo[-1] + terms[-1]
    sums = jnp.stack([jnp.where(last, full, s) for s in loo])
    vv = (prior_llr + sums).reshape(e.shape)
    return graph.to_check(vv)


def _not_converged_mask_llr(v: jnp.ndarray, band: float) -> jnp.ndarray:
    """Per-lane 'not converged': some finite message with |llr| < band — the
    LLR image of the reference band test (DecoderCPU.h:231-246)."""
    inside = jnp.abs(v) < band
    return jnp.any(inside, axis=0)


@partial(jax.jit, static_argnames=("graph", "max_iters", "check_every",
                                   "conv_low", "alpha"))
def min_sum_run(
    graph: CirculantGraph,
    syndrome: jnp.ndarray,   # (num_checks, batch) in {0, 1}
    prior: jnp.ndarray,      # scalar/(batch,) channel error prob (2/3-scaled)
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    alpha: float = 0.75,
    damping: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run normalized min-sum.  Returns (v_final LLRs (num_edges, batch),
    iters_executed) — same contract as sum_product.bp_run but in LLR domain.

    ``damping``: optional per-edge memory coefficients, check-indexed
    ``(num_edges, batch)`` in [0, 1): each iteration blends
    ``v = damping * v_old + (1 - damping) * v_standard``.  Uniform damping is
    the classic BP stabilizer; RANDOM per-variable damping across ensemble
    retries breaks trapping-set symmetry — the engine of the relay decoder
    (decoder/relay.py).  ``None`` (default) is the exact undamped update.
    """
    batch = syndrome.shape[-1]
    sign = graph.expand_checks(1.0 - 2.0 * syndrome.astype(jnp.float32))
    prior = jnp.asarray(prior, dtype=jnp.float32)
    prior_llr = jnp.log1p(-prior) - jnp.log(prior)
    band = float(np_log_band(conv_low))
    v0 = jnp.broadcast_to(prior_llr, (graph.num_edges, batch)).astype(jnp.float32) + 0.0 * sign
    done0 = jnp.any(syndrome < 0, axis=0)  # all-False, syndrome-typed

    # sharded adapters must keep every mesh device in the loop until the
    # globally-slowest lane converges: collectives inside the body rendezvous
    # across the whole mesh, so divergent trip counts deadlock.  The combined
    # continue flag equals the single-device loop's (it runs until ALL batch
    # lanes are done), so iteration counts stay bit-identical.
    combine_cont = getattr(graph, "combine_continue", None)

    def cond(state):
        n, _, done = state
        cont = ~jnp.all(done)
        if combine_cont is not None:
            cont = combine_cont(cont)
        return (n < max_iters) & cont

    def body(state):
        n, v, done = state
        e = cn_update_min_sum(graph, v, sign, alpha)
        v_new = vn_update_llr(graph, e, prior_llr, last=(n == max_iters - 1))
        if damping is not None:
            v_new = damping * v + (1.0 - damping) * v_new
        v_new = jnp.where(done[None, :], v, v_new)
        check_now = (n % check_every) == 0
        mask = _not_converged_mask_llr(v_new, band)
        # graph-sharded adapters (parallel/lifted_sharded.py) combine the
        # per-shard lane mask across the graph axis so every shard's
        # while_loop takes the same number of iterations (collectives inside
        # the body would otherwise deadlock on divergent trip counts)
        combine = getattr(graph, "combine_lane_mask", None)
        if combine is not None:
            mask = combine(mask)
        conv = check_now & ~mask
        return n + 1, v_new, done | conv

    n_final, v_final, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), v0, done0))
    return v_final, n_final


def np_log_band(conv_low: float) -> float:
    """Probability band edge -> LLR magnitude: p in (low, 1-low) iff
    |llr| < log((1-low)/low)."""
    import math

    return math.log((1.0 - conv_low) / conv_low)
