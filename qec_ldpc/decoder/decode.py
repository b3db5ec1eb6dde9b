"""Full X/Z decode with hard decision and error-code flags.

Reproduces the semantics of ``DecoderCPU::Decode`` (``DecoderCPU.h:317-390``):
decode the X and Z syndromes with BP, hard-decide each variable as flipped if
**any** of its incident messages >= 0.5 (the reference's any-edge quirk,
DecoderCPU.h:354-373 — not a posterior mean), flag per-sample convergence
failures from a final CheckConvergence pass, and flag syndrome failures by
re-encoding the decision and comparing syndromes.

The reference runs X and Z as two OpenMP sections (DecoderCPU.h:329-345); here
they are two batched BP runs inside one jit — XLA schedules them back to back
on the same chip, and the batch axis supplies the parallelism.

ErrorCode bitmask matches ``Decoder.h:14-23``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from qec_ldpc.codes.css import QuantumLDPCCode
from qec_ldpc.decoder.layout import CirculantGraph
from qec_ldpc.decoder.min_sum import (
    _not_converged_mask_llr,
    min_sum_run,
    np_log_band,
)
from qec_ldpc.decoder.sum_product import BPConfig, _not_converged_mask, bp_run

# ErrorCode bit flags (Decoder.h:14-23)
SUCCESS = 0
SYNDROME_FAIL_X = 1
SYNDROME_FAIL_Z = 2
CONVERGENCE_FAIL_X = 4
CONVERGENCE_FAIL_Z = 8


@dataclasses.dataclass(frozen=True, eq=False)
class CodeGraphs:
    """Static decode-time structure for one code: the X and Z circulant graphs."""

    code: QuantumLDPCCode
    x: CirculantGraph
    z: CirculantGraph

    @staticmethod
    def build(code: QuantumLDPCCode) -> "CodeGraphs":
        return CodeGraphs(
            code=code,
            x=CirculantGraph.from_table(code.hc, code.P),
            z=CirculantGraph.from_table(code.hd, code.P),
        )


@partial(jax.tree_util.register_dataclass,
         data_fields=("decisions_x", "decisions_z", "error_code", "iters_x",
                      "iters_z", "iter_samples_x", "iter_samples_z",
                      "soft_x", "soft_z"),
         meta_fields=())
@dataclasses.dataclass
class DecodeResult:
    """Batched decode output; all arrays have trailing batch axis."""

    decisions_x: jnp.ndarray  # (num_vars, batch) int8 hard decisions
    decisions_z: jnp.ndarray
    error_code: jnp.ndarray   # (batch,) int32 bitmask
    iters_x: jnp.ndarray      # () max iterations executed by any batch lane
    iters_z: jnp.ndarray
    #: () total executed lane-iterations — the HONEST work measure under
    #: early exit (SURVEY §7: masked/executed iterations must be counted
    #: faithfully).  The loop runs every lane until the whole batch has
    #: converged, so this is iters * batch (plus relay retries' work).
    iter_samples_x: jnp.ndarray
    iter_samples_z: jnp.ndarray
    #: (num_vars, batch) float32 posterior-LLR proxies (smaller = more likely
    #: in error), only with cfg.return_soft — consumed by OSD (decoder/osd.py)
    soft_x: jnp.ndarray | None = None
    soft_z: jnp.ndarray | None = None


def _decode_one_graph(graph, syndrome, prior, cfg: BPConfig):
    # the layered schedule is specialized to single-circulant graphs; lifted
    # graphs (decoder/lifted.py, e.g. bivariate bicycle codes) decode via
    # flooding
    is_circulant = isinstance(graph, CirculantGraph)
    if not is_circulant and cfg.algorithm == "layered-min-sum":
        raise ValueError(
            "layered-min-sum requires a CirculantGraph (block-row layers of "
            "a lifted graph are not variable-disjoint); use algorithm="
            "'min-sum' for lifted codes")
    if cfg.algorithm == "layered-min-sum":
        from qec_ldpc.decoder.layered import layered_min_sum_run

        q, iters = layered_min_sum_run(
            graph, syndrome, prior,
            max_iters=cfg.max_iters, check_every=cfg.layered_check_every,
            alpha=cfg.min_sum_alpha,
        )
        iter_samples = iters * syndrome.shape[-1]
        # layered maintains posteriors natively: hard decision is q <= 0;
        # "failed to converge" === hard decision violates the syndrome, so
        # conv_fail is derived from the common re-encode below
        decisions = (q <= 0.0).astype(jnp.int8)
        s_hat = graph.syndrome(decisions.astype(jnp.int32))
        syn_fail = jnp.any(s_hat != syndrome, axis=0)
        soft = q if cfg.return_soft else None  # layered q IS the posterior
        return decisions, syn_fail, syn_fail, iters, iter_samples, soft
    if cfg.algorithm == "min-sum":
        v, iters = min_sum_run(
            graph, syndrome, prior,
            max_iters=cfg.max_iters, check_every=cfg.check_every,
            conv_low=cfg.conv_low, alpha=cfg.min_sum_alpha,
        )
        # the loop runs every lane until the global exit
        iter_samples = iters * syndrome.shape[-1]
        # LLR images of the reference's probability-domain semantics:
        # "any incident message >= 0.5" <=> any incident llr <= 0
        vv = graph.vn_view(graph.to_var(v))  # (B, num_vars, batch)
        decisions = jnp.any(vv <= 0.0, axis=0).astype(jnp.int8)
        conv_fail = _not_converged_mask_llr(v, np_log_band(cfg.conv_low))
        # sum of the B outgoing edge LLRs: an affine image of the posterior
        # LLR within a lane (each edge = prior + leave-one-out sum, so the
        # sum = B*prior + (B-1)*(posterior - prior)) — exact ranking for OSD
        soft = jnp.sum(vv, axis=0) if cfg.return_soft else None
    else:
        v, iters = bp_run(
            graph, syndrome, prior,
            max_iters=cfg.max_iters, check_every=cfg.check_every,
            conv_low=cfg.conv_low, conv_high=cfg.conv_high,
        )
        iter_samples = iters * syndrome.shape[-1]
        # hard decision: any incident message >= 0.5 (DecoderCPU.h:354-373)
        vv = graph.vn_view(graph.to_var(v))  # (B, num_vars, batch)
        decisions = jnp.any(vv >= cfg.hard_threshold, axis=0).astype(jnp.int8)
        conv_fail = _not_converged_mask(v, cfg.conv_low, cfg.conv_high)  # (batch,)
        if cfg.return_soft:
            # probability-domain messages -> summed edge LLRs (same affine-
            # image ranking argument as the min-sum path).  Saturated lanes
            # can hold NaN messages (0/0 in the masked VN posterior between
            # convergence checks — see decoder/validate.py); a NaN edge
            # carries no usable information, so it contributes 0 LLR.
            vc = jnp.clip(vv, 1e-12, 1.0 - 1e-7)
            term = jnp.log1p(-vc) - jnp.log(vc)
            soft = jnp.sum(jnp.where(jnp.isnan(vv), 0.0, term), axis=0)
        else:
            soft = None
    # re-encode and compare syndromes (DecoderCPU.h:380-384)
    s_hat = graph.syndrome(decisions.astype(jnp.int32))
    syn_fail = jnp.any(s_hat != syndrome, axis=0)
    return decisions, conv_fail, syn_fail, iters, iter_samples, soft


@partial(jax.jit, static_argnames=("graphs", "cfg"))
def decode_batch(
    graphs: CodeGraphs,
    syndrome_x: jnp.ndarray,  # (J*P, batch) in {0,1}
    syndrome_z: jnp.ndarray,  # (K*P, batch)
    error_probability: jnp.ndarray | float,
    cfg: BPConfig = BPConfig(),
) -> DecodeResult:
    prior = jnp.float32(cfg.prior_factor) * jnp.asarray(error_probability, jnp.float32)
    dx, cfx, sfx, itx, isx, softx = _decode_one_graph(
        graphs.x, syndrome_x, prior, cfg)
    dz, cfz, sfz, itz, isz, softz = _decode_one_graph(
        graphs.z, syndrome_z, prior, cfg)
    code = (
        sfx.astype(jnp.int32) * SYNDROME_FAIL_X
        + sfz.astype(jnp.int32) * SYNDROME_FAIL_Z
        + cfx.astype(jnp.int32) * CONVERGENCE_FAIL_X
        + cfz.astype(jnp.int32) * CONVERGENCE_FAIL_Z
    )
    return DecodeResult(decisions_x=dx, decisions_z=dz, error_code=code,
                        iters_x=itx, iters_z=itz,
                        iter_samples_x=isx, iter_samples_z=isz,
                        soft_x=softx, soft_z=softz)


def syndromes_from_errors(
    graphs: CodeGraphs, x_errors: jnp.ndarray, z_errors: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(num_vars, batch) error bits -> ((J*P, batch), (K*P, batch)) syndromes."""
    return graphs.x.syndrome(x_errors), graphs.z.syndrome(z_errors)
