"""Batched LAYERED (serial-schedule) normalized min-sum BP.

Framework-native third decode algorithm (beyond the reference's flooding
sum-product, ``DecoderCPU.h:150-292``, and this framework's flooding min-sum).
Layered decoding is the standard production-LDPC schedule: check layers are
processed sequentially within one iteration and each layer immediately updates
the variable posteriors, so information propagates across the whole graph
within a single sweep.  On QC codes the natural layer is a **block-row of
circulants** (all ``P`` checks of block-row ``b`` are variable-disjoint within
each block column, so the layer update is fully vectorizable) — empirically it
converges in roughly half the flooding iterations at equal or better logical
error rate.

State per batch lane:
  * ``q``  — posterior LLRs, var-indexed ``(num_vars, batch)``
  * ``r``  — check->var messages, check-indexed ``(num_edges, batch)``

Per layer ``b`` (one sweep = all ``B`` layers):
  1. ``t[l] = to_check(q[l]) - r[b,l]``        (leave-out own message)
  2. ``r'[b,l] = sign * alpha * loo_sign(t) * loo_min(|t|)``  (min-sum CN)
  3. ``q[l] += to_var(r'[b,l] - r[b,l])``;  ``r[b,l] = r'[b,l]``

LLR convention matches decoder/min_sum.py: ``llr = log(P(0)/P(1))``, so the
hard decision is ``q <= 0``.  Convergence is the standard layered criterion:
the hard decision satisfies the input syndrome — tested with a pure-sign
parity product (no integer mod), every ``check_every`` iterations, with
converged lanes frozen inside the ``lax.while_loop`` exactly like
decoder/sum_product.py.

Same flat rank-2 layouts and static slice+concat rolls as the rest of the
decoder (the flat rank-2 static-roll layout of decoder/layout.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from qec_ldpc.decoder.layout import CirculantGraph
from qec_ldpc.decoder.min_sum import _loo_mins, _loo_sign_products


def _block(x: jnp.ndarray, i: int, P: int) -> jnp.ndarray:
    return jax.lax.slice_in_dim(x, i * P, (i + 1) * P, axis=0)


def _roll(x: jnp.ndarray, s: int, P: int) -> jnp.ndarray:
    """out[r] = x[(r + s) % P] as two static slices + concat."""
    s = int(s) % P
    if s == 0:
        return x
    return jnp.concatenate(
        [jax.lax.slice_in_dim(x, s, P, axis=0),
         jax.lax.slice_in_dim(x, 0, s, axis=0)], axis=0)


def syndrome_satisfied(graph: CirculantGraph, q: jnp.ndarray,
                       syn_sign: jnp.ndarray) -> jnp.ndarray:
    """Per-lane: hard decision of posteriors ``q`` satisfies the syndrome.

    Pure sign arithmetic: the parity of block-row ``b`` of the hard decision
    ``d = (q <= 0)`` is ``prod_l sign(q)[rolled]``; it must equal the
    syndrome sign ``1 - 2*s``.  ``syn_sign``: (num_checks, batch) +-1.
    """
    P = graph.P
    d_sign = jnp.where(q <= 0.0, -1.0, 1.0)   # (num_vars, batch)
    rows = []
    for b in range(graph.B):
        acc = None
        for l in range(graph.L):
            blk = _roll(_block(d_sign, l, P), graph.table[b, l], P)
            acc = blk if acc is None else acc * blk
        rows.append(acc)
    parity = jnp.concatenate(rows, axis=0)     # (num_checks, batch)
    return jnp.all(parity == syn_sign, axis=0)


@partial(jax.jit, static_argnames=("graph", "max_iters", "check_every",
                                   "alpha"))
def layered_min_sum_run(
    graph: CirculantGraph,
    syndrome: jnp.ndarray,   # (num_checks, batch) in {0, 1}
    prior: jnp.ndarray,      # scalar/(batch,) channel error prob (2/3-scaled)
    max_iters: int,
    check_every: int = 1,
    alpha: float = 0.75,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run layered normalized min-sum.

    Returns ``(q_final, iters_executed)`` where ``q_final`` are posterior
    LLRs ``(num_vars, batch)`` (NOT per-edge messages — the layered schedule
    maintains posteriors natively) and ``iters_executed`` is the number of
    full sweeps run before every lane converged or the cap was hit.

    ``check_every`` defaults to 1 (not the flooding paths' 10): layered
    convergence is a cheap sign-product parity test and typical convergence
    is only a handful of sweeps, so testing every sweep saves real work.
    """
    batch = syndrome.shape[-1]
    P, B, L = graph.P, graph.B, graph.L
    syn_sign = 1.0 - 2.0 * syndrome.astype(jnp.float32)   # (num_checks, batch)
    prior = jnp.asarray(prior, dtype=jnp.float32)
    prior_llr = jnp.log1p(-prior) - jnp.log(prior)

    q0 = (jnp.broadcast_to(prior_llr, (graph.num_vars, batch))
          .astype(jnp.float32) + 0.0 * jnp.sum(syn_sign, axis=0))
    r0 = jnp.zeros((graph.num_edges, batch), jnp.float32) + 0.0 * q0[0]
    done0 = jnp.any(syndrome < 0, axis=0)  # all-False, syndrome-typed

    def sweep(q, r):
        """One full iteration: serial pass over the B block-row layers."""
        for b in range(B):
            sgn_b = _block(syn_sign, b, P)               # (P, batch)
            ts = []
            for l in range(L):
                qc = _roll(_block(q, l, P), graph.table[b, l], P)
                ts.append(qc - _block(r, b * L + l, P))
            mags = [jnp.abs(t) for t in ts]
            sgns = [jnp.where(t < 0, -1.0, 1.0) for t in ts]
            loo_min = _loo_mins(mags)
            loo_sgn = _loo_sign_products(sgns)
            q_blocks = []
            r_blocks = []
            for l in range(L):
                r_new = alpha * sgn_b * loo_sgn[l] * loo_min[l]
                qc_new = ts[l] + r_new
                q_blocks.append(_roll(qc_new, (-graph.table[b, l]) % P, P))
                r_blocks.append(r_new)
            q = jnp.concatenate(q_blocks, axis=0)
            r = jnp.concatenate(
                [jax.lax.slice_in_dim(r, 0, b * L * P, axis=0)]
                + r_blocks
                + [jax.lax.slice_in_dim(r, (b + 1) * L * P,
                                        graph.num_edges, axis=0)],
                axis=0)
        return q, r

    def cond(state):
        n, _, _, done = state
        return (n < max_iters) & ~jnp.all(done)

    def body(state):
        n, q, r, done = state
        q_new, r_new = sweep(q, r)
        q_new = jnp.where(done[None, :], q, q_new)
        r_new = jnp.where(done[None, :], r, r_new)
        check_now = (n % check_every) == (check_every - 1)
        conv = check_now & syndrome_satisfied(graph, q_new, syn_sign)
        return n + 1, q_new, r_new, done | conv

    n_final, q_final, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), q0, r0, done0))
    return q_final, n_final
