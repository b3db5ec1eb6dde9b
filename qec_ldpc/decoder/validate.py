"""Numerical validation / sanitizer layer for the decode path.

The reference's concurrency-correctness tooling was an RNG lock, atomic
counters, and a race-avoidance comment in the CDP kernel
(``DecoderCPU.h:411,448-459``, ``kernels.cu:49-54``); under JAX functional
purity removes data races outright, and the remaining failure mode is
NUMERICAL: probability-domain BP saturates to exact 0/1 on long runs and the
posterior then evaluates 0/0 -> NaN (a trap that invalidated early timing
harnesses — see ARCHITECTURE.md).  This module is the ``checkify``-based
sanitizer SURVEY §5 calls for: run any decode under float checks (NaN/Inf
detection threaded through ``lax.while_loop``), plus a host-side structural
validator for decode results.

Debug tooling, not the hot path: checkify instruments every float op, so use
it in tests and when chasing numerics, never inside benchmarks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify

from qec_ldpc.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    DecodeResult,
    decode_batch,
)
from qec_ldpc.decoder.sum_product import BPConfig


def checked_decode_batch(
    graphs: CodeGraphs,
    syndrome_x: jnp.ndarray,
    syndrome_z: jnp.ndarray,
    error_probability,
    cfg: BPConfig = BPConfig(),
):
    """Run ``decode_batch`` under ``checkify`` float checks (NaN/Inf/div0
    anywhere in the traced decode, including inside the BP ``while_loop``).

    Returns ``(err, result)``; call ``err.throw()`` to raise on the first
    violation, or inspect ``err.get()``.

    Interpreting hits: probability-domain sum-product SATURATES messages to
    exact f32 0/1 within ~8 iterations on easy syndromes, after which the
    (masked, discarded) leave-one-out posterior computes 0/0 — so on healthy
    long runs the first reported error is a ``DivisionByZeroError`` from the
    VN update; that is the known-benign saturation signature (the C++
    reference computes the identical expression, ``DecoderCPU.h:191-226``).
    A ``NaNError`` surfacing *earlier* than saturation, errors at small
    ``max_iters``, or non-finite values reaching the OUTPUTS (use
    :func:`validate_decode_result`) indicate real trouble — e.g. a degenerate
    prior (p >= 1 after the 2/3 factor) trips within the first iterations.
    """
    def run(sx, sz, p):
        return decode_batch(graphs, sx, sz, p, cfg)

    checked = checkify.checkify(run, errors=checkify.float_checks)
    return checked(syndrome_x, syndrome_z,
                   jnp.asarray(error_probability, jnp.float32))


def validate_decode_result(
    graphs: CodeGraphs,
    syndrome_x,
    syndrome_z,
    res: DecodeResult,
) -> list[str]:
    """Host-side structural validation of a decode result.  Returns a list of
    violation descriptions (empty = valid):

    * decisions are 0/1
    * SYNDROME_FAIL_X/Z bits agree exactly with re-encoding the decisions
      (the decode-internal re-encode semantics, DecoderCPU.h:380-384)
    * soft outputs, when present, are finite
    """
    problems: list[str] = []
    dx = np.asarray(res.decisions_x)
    dz = np.asarray(res.decisions_z)
    ec = np.asarray(res.error_code)
    for name, d in (("x", dx), ("z", dz)):
        if not np.isin(d, (0, 1)).all():
            problems.append(f"decisions_{name} not in {{0,1}}")
    for name, bit, graph, syn, d in (
        ("x", SYNDROME_FAIL_X, graphs.x, syndrome_x, dx),
        ("z", SYNDROME_FAIL_Z, graphs.z, syndrome_z, dz),
    ):
        s_hat = np.asarray(graph.syndrome(jnp.asarray(d, jnp.int32)))
        mismatch = (s_hat != np.asarray(syn)).any(axis=0)
        flagged = (ec & bit) != 0
        if not np.array_equal(mismatch, flagged):
            problems.append(
                f"SYNDROME_FAIL_{name.upper()} disagrees with re-encoded "
                f"syndrome on {int((mismatch != flagged).sum())} lane(s)")
    for name, soft in (("x", res.soft_x), ("z", res.soft_z)):
        if soft is not None and not np.isfinite(np.asarray(soft)).all():
            problems.append(f"soft_{name} contains non-finite values")
    return problems
