"""Batched probability-domain sum-product BP over a circulant Tanner graph.

Faithful batched re-design of the reference decode loop
(``DecoderCPU.h:150-292``, CUDA twins ``kernels.cu:95-250``):

  * check-node rule  0.5*(1 -+ prod(1 - 2 p))      (DecoderCPU.h:153-183)
  * var-node rule    pch*prod(p) / (pch*prod(p) + (1-pch)*prod(1-p)),
    excluding the target check unless the *last* iteration, which forms the
    full posterior                                  (DecoderCPU.h:188-229)
  * convergence: every nonzero message outside (low, high), tested every
    ``check_every`` iterations starting at iteration 0
                                                    (DecoderCPU.h:231-246,287-290)
  * per-sample early exit: the reference breaks out of the loop per decode
    (DecoderCPU.h:280-291); here converged batch lanes are frozen inside one
    ``lax.while_loop`` and the loop ends when all lanes are done or the
    iteration cap is reached.

Messages are kept flat (num_edges, batch) in check-indexed order (see
decoder/layout.py); batch is the trailing axis.  Everything is static-shape,
gather-free, and jit/vmap/shard_map friendly.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from qec_ldpc.decoder.layout import CirculantGraph


@dataclasses.dataclass(frozen=True)
class BPConfig:
    """Decode-loop knobs; defaults are the reference's hard-coded constants
    (SURVEY §5 config inventory: DecoderCPU.h:259-261,287,357)."""

    max_iters: int = 100
    check_every: int = 10
    conv_low: float = 0.01
    conv_high: float = 0.99
    #: channel-prior factor: p = prior_factor * physical error probability
    #: (the X-or-Y marginal of a uniform X/Y/Z error, DecoderCPU.h:259,325)
    prior_factor: float = 2.0 / 3.0
    hard_threshold: float = 0.5
    #: "sum-product" (probability domain, reference-faithful), "min-sum"
    #: (flooding normalized min-sum in LLR domain, decoder/min_sum.py), or
    #: "layered-min-sum" (serial block-row schedule, decoder/layered.py —
    #: converges in roughly half the flooding sweeps)
    algorithm: str = "sum-product"
    #: normalization factor for min-sum check-node messages
    min_sum_alpha: float = 0.75
    #: convergence-test period for the layered schedule (its hard-decision
    #: parity test is cheap and convergence is fast, so every sweep pays off)
    layered_check_every: int = 1
    #: also return per-variable soft outputs (posterior-LLR proxies,
    #: (num_vars, batch) per graph) in DecodeResult.soft_x/soft_z — the
    #: reliability ranking consumed by OSD post-processing (decoder/osd.py).
    #: Within a lane the value is an affine function of the true posterior
    #: LLR, so the per-lane ordering (all OSD uses) is exact.
    return_soft: bool = False


def _loo_products(terms: list[jnp.ndarray]) -> list[jnp.ndarray]:
    """Leave-one-out products of a small static list via unrolled exclusive
    prefix/suffix products.  Numerically robust at zeros (unlike
    divide-by-total) and lowers to plain fused elementwise multiplies.
    Matches the reference's explicit skip-one serial
    products (DecoderCPU.h:170-176, 214-223) up to float association order."""
    m = len(terms)
    ones = jnp.ones_like(terms[0])
    prefix = [ones] * m
    for i in range(1, m):
        prefix[i] = prefix[i - 1] * terms[i - 1]
    suffix = [ones] * m
    for i in range(m - 2, -1, -1):
        suffix[i] = suffix[i + 1] * terms[i + 1]
    return [prefix[i] * suffix[i] for i in range(m)]


def _not_converged_mask(v: jnp.ndarray, low: float, high: float) -> jnp.ndarray:
    """Per-batch-lane 'not converged': some nonzero message strictly inside
    (low, high) — exact CheckConvergence semantics (DecoderCPU.h:231-246)."""
    inside = (v != 0.0) & (v > low) & (v < high)
    return jnp.any(inside, axis=0)


def cn_update(graph: CirculantGraph, v: jnp.ndarray, syndrome_sign_half: jnp.ndarray) -> jnp.ndarray:
    """Check-node update. v, result: check-indexed (num_edges, batch).

    syndrome_sign_half: per-edge rows (num_edges, batch) = 0.5 - syndrome
    (i.e. +-0.5, exact in float), so that
    E = 0.5 - sgn_half * prod_{l' != l}(1 - 2 v) reproduces both branches of
    DecoderCPU.h:178-183 with a single fused expression.
    """
    t = graph.cn_view(1.0 - 2.0 * v)          # (B, L, P*batch)
    loo = _loo_products([t[:, i] for i in range(graph.check_degree)])
    prod = jnp.stack(loo, axis=1).reshape(v.shape)
    return 0.5 - syndrome_sign_half * prod


def vn_update(
    graph: CirculantGraph, e: jnp.ndarray, prior: jnp.ndarray | float, last: jnp.ndarray
) -> jnp.ndarray:
    """Variable-node update.  e: check-indexed; returns check-indexed v.

    ``last`` is a traced bool scalar: when true, the own-check message is
    included, forming the posterior (DecoderCPU.h:216 ``if (j == k && !last)``).
    """
    ev = graph.vn_view(graph.to_var(e))       # (B, L*P, batch), var-indexed
    terms_p = [ev[i] for i in range(graph.var_degree)]
    terms_m = [1.0 - ev[i] for i in range(graph.var_degree)]
    loo_p = _loo_products(terms_p)
    loo_m = _loo_products(terms_m)
    # full product in ascending-index association order (== loo of the last
    # element times the last element)
    full_p = loo_p[-1] * terms_p[-1]
    full_m = loo_m[-1] * terms_m[-1]
    prod_p = jnp.stack([jnp.where(last, full_p, lp) for lp in loo_p])
    prod_m = jnp.stack([jnp.where(last, full_m, lm) for lm in loo_m])
    num = prior * prod_p
    den = (1.0 - prior) * prod_m + num
    vv = (num / den).reshape(e.shape)
    return graph.to_check(vv)


@partial(jax.jit, static_argnames=("graph", "max_iters", "check_every"))
def bp_run(
    graph: CirculantGraph,
    syndrome: jnp.ndarray,  # (num_checks, batch) in {0, 1}
    prior: jnp.ndarray,     # scalar or (batch,) channel prior (already 2/3-scaled)
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    conv_high: float = 0.99,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run BP for one graph.  Returns (v_final, iters_executed).

    v_final: check-indexed var->check messages (num_edges, batch) — the same
    quantity the reference's ``varNodes`` array holds at loop exit, from which
    hard decisions and the final convergence flags are derived.
    """
    batch = syndrome.shape[-1]
    sign = graph.expand_checks(0.5 - syndrome.astype(jnp.float32))
    prior = jnp.asarray(prior, dtype=jnp.float32)
    # derive the initial carry from the (possibly device-varying) syndrome so
    # its sharding type matches the loop body's outputs under shard_map
    v0 = jnp.broadcast_to(prior, (graph.num_edges, batch)).astype(jnp.float32) + 0.0 * sign
    done0 = jnp.any(syndrome < 0, axis=0)  # all-False, syndrome-typed

    # see decoder/min_sum.py: sharded adapters combine the continue flag
    # across the mesh so in-body collectives never see divergent trip counts
    combine_cont = getattr(graph, "combine_continue", None)

    def cond(state):
        n, _, done = state
        cont = ~jnp.all(done)
        if combine_cont is not None:
            cont = combine_cont(cont)
        return (n < max_iters) & cont

    def body(state):
        n, v, done = state
        e = cn_update(graph, v, sign)
        v_new = vn_update(graph, e, prior, last=(n == max_iters - 1))
        v_new = jnp.where(done[None, :], v, v_new)
        # convergence test every check_every iterations, starting at n=0
        # (plain masking, not lax.cond: branch result types diverge under
        # shard_map's varying-axes tracking, and the test is one cheap pass)
        check_now = (n % check_every) == 0
        mask = _not_converged_mask(v_new, conv_low, conv_high)
        # graph-sharded adapters combine the per-shard lane mask across the
        # graph axis so all shards' while_loops stay in lockstep (see
        # decoder/min_sum.py for the rationale)
        combine = getattr(graph, "combine_lane_mask", None)
        if combine is not None:
            mask = combine(mask)
        conv = check_now & ~mask
        return n + 1, v_new, done | conv

    n_final, v_final, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), v0, done0))
    return v_final, n_final
