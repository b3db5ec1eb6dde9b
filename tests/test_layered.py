"""Layered (serial-schedule) normalized min-sum: the decode loop and its
decode_batch integration.

The layered schedule is a framework-native extension beyond the reference's
flooding sum-product (``DecoderCPU.h:150-292``); correctness here is anchored
to (a) exact decoding of low-weight errors, (b) the syndrome-satisfied
convergence criterion agreeing with an explicit re-encode, (c) converging in
no more sweeps than flooding min-sum needs iterations.
"""

import numpy as np
import jax
import jax.numpy as jnp

from qec_ldpc.decoder import BPConfig, decode_batch, layered_min_sum_run, min_sum_run
from qec_ldpc.decoder.layered import syndrome_satisfied
from qec_ldpc.sampling import sample_weight_w_errors

PRIOR = jnp.float32(2.0 / 3.0 * 0.02)


def _errors_and_syndromes(code, graphs, weight, batch, seed=0):
    xe, _ = sample_weight_w_errors(jax.random.PRNGKey(seed), code.n, weight, batch)
    return xe, graphs.x.syndrome(xe.astype(jnp.int32))


def test_weight1_decodes_exactly_in_few_sweeps(small_code, small_graphs):
    xe, syn = _errors_and_syndromes(small_code, small_graphs, 1, 32, seed=1)
    q, iters = layered_min_sum_run(small_graphs.x, syn, PRIOR, max_iters=50)
    decisions = np.asarray(q <= 0.0).astype(int)
    assert (decisions == np.asarray(xe)).all()
    assert int(iters) <= 3  # layered converges in a couple of sweeps


def test_syndrome_satisfied_matches_reencode(small_code, small_graphs):
    _, syn = _errors_and_syndromes(small_code, small_graphs, 2, 64)
    q, _ = layered_min_sum_run(small_graphs.x, syn, PRIOR, max_iters=50)
    syn_sign = 1.0 - 2.0 * syn.astype(jnp.float32)
    sat = np.asarray(syndrome_satisfied(small_graphs.x, q, syn_sign))
    d = np.asarray(q <= 0.0).astype(np.int32)
    s_hat = np.asarray(small_graphs.x.syndrome(jnp.asarray(d)))
    assert (sat == (s_hat == np.asarray(syn)).all(axis=0)).all()


def test_converges_no_slower_than_flooding(small_code, small_graphs):
    """On converging lanes the layered schedule needs no more sweeps than
    flooding min-sum needs iterations (typically about half)."""
    _, syn = _errors_and_syndromes(small_code, small_graphs, 1, 64, seed=5)
    _, it_layered = layered_min_sum_run(small_graphs.x, syn, PRIOR,
                                        max_iters=50, check_every=1)
    _, it_flooding = min_sum_run(small_graphs.x, syn, PRIOR, max_iters=50,
                                 check_every=1)
    assert int(it_layered) <= int(it_flooding)


def test_decode_batch_integration(small_code, small_graphs):
    """Full X/Z decode with classification flags; weight-1 errors decode to
    SUCCESS on every lane."""
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(9), small_code.n, 1, 16)
    sx = small_graphs.x.syndrome(xe.astype(jnp.int32))
    sz = small_graphs.z.syndrome(ze.astype(jnp.int32))
    cfg = BPConfig(max_iters=50, algorithm="layered-min-sum")
    res = decode_batch(small_graphs, sx, sz, 0.02, cfg)
    assert (np.asarray(res.error_code) == 0).all()
    assert (np.asarray(res.decisions_x) == np.asarray(xe)).all()
    assert (np.asarray(res.decisions_z) == np.asarray(ze)).all()
    # every lane runs until the whole batch has converged
    assert int(res.iter_samples_x) == int(res.iters_x) * 16
