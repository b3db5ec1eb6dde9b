"""Normalized min-sum decoder (BASELINE config 2: batched min-sum, fixed
50-iteration cap).

Min-sum has no reference twin (the C++ code is sum-product only,
DecoderCPU.h:150-229), so it is validated by decoding properties and by
cross-checking against the sum-product decoder on easy instances.
"""

import numpy as np
import jax
import jax.numpy as jnp

from qec_ldpc.decoder import BPConfig, decode_batch, min_sum_run
from qec_ldpc.sampling import sample_weight_w_errors

MS_CFG = BPConfig(max_iters=50, algorithm="min-sum")


def test_weight_one_errors_all_corrected(small_code, small_graphs):
    code, graphs = small_code, small_graphs
    n, batch = code.n, 128
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(3), n, 1, batch)
    sx = graphs.x.syndrome(xe.astype(jnp.int32))
    sz = graphs.z.syndrome(ze.astype(jnp.int32))
    res = decode_batch(graphs, sx, sz, 0.02, MS_CFG)
    assert np.array_equal(np.asarray(res.decisions_x), np.asarray(xe))
    assert np.array_equal(np.asarray(res.decisions_z), np.asarray(ze))
    assert (np.asarray(res.error_code) == 0).all()


def test_all_zero_syndrome_decodes_to_zero(small_code, small_graphs):
    code, graphs = small_code, small_graphs
    sx = jnp.zeros((code.num_eqs_x, 4), dtype=jnp.int32)
    sz = jnp.zeros((code.num_eqs_z, 4), dtype=jnp.int32)
    res = decode_batch(graphs, sx, sz, 0.05, MS_CFG)
    assert np.asarray(res.decisions_x).sum() == 0
    assert np.asarray(res.decisions_z).sum() == 0
    assert (np.asarray(res.error_code) == 0).all()


def test_fixed_iteration_cap_respected(small_code, small_graphs):
    """With early exit disabled (check_every > max_iters) the loop runs
    exactly max_iters iterations — the fixed-50-cap benchmark mode."""
    code, graphs = small_code, small_graphs
    syn = jnp.zeros((code.num_eqs_x, 8), dtype=jnp.int32).at[0, :].set(1)
    _, iters = min_sum_run(graphs.x, syn, jnp.float32(0.02), max_iters=50,
                           check_every=51)
    assert int(iters) == 50


def test_early_exit_on_convergence(small_code, small_graphs):
    code, graphs = small_code, small_graphs
    n = code.n
    easy = np.zeros((n, 1), dtype=np.int64)
    easy[3, 0] = 1
    syn = jnp.asarray(code.syndrome_x(easy.T).T)
    _, iters = min_sum_run(graphs.x, syn, jnp.float32(2 / 3 * 0.02),
                           max_iters=50, check_every=10)
    assert int(iters) <= 11


def test_agrees_with_sum_product_on_easy_batch(small_code, small_graphs, rng):
    """On well-separated weight-1/2 errors both algorithms must produce the
    same corrections (min-sum only approximates CN magnitudes; signs and easy
    decisions agree)."""
    code, graphs = small_code, small_graphs
    n, batch = code.n, 64
    xs = np.zeros((n, batch), dtype=np.int64)
    zs = np.zeros((n, batch), dtype=np.int64)
    for b in range(batch):
        xs[rng.choice(n, 1), b] = 1
        zs[rng.choice(n, 1), b] = 1
    sx = jnp.asarray(code.syndrome_x(xs.T).T)
    sz = jnp.asarray(code.syndrome_z(zs.T).T)
    res_sp = decode_batch(graphs, sx, sz, 0.02, BPConfig(max_iters=50))
    res_ms = decode_batch(graphs, sx, sz, 0.02, MS_CFG)
    assert np.array_equal(np.asarray(res_sp.decisions_x),
                          np.asarray(res_ms.decisions_x))
    assert np.array_equal(np.asarray(res_sp.decisions_z),
                          np.asarray(res_ms.decisions_z))


def test_llr_signs_are_probability_images(small_code, small_graphs):
    """Decoded messages: llr <= 0 lanes correspond to sum-product messages
    >= 0.5 on a converged easy instance (the semantic mapping used for hard
    decisions)."""
    code, graphs = small_code, small_graphs
    n = code.n
    err = np.zeros((n, 1), dtype=np.int64)
    err[5, 0] = 1
    syn = jnp.asarray(code.syndrome_x(err.T).T)
    from qec_ldpc.decoder import bp_run

    prior = jnp.float32(2 / 3 * 0.02)
    v_sp, _ = bp_run(graphs.x, syn, prior, max_iters=30)
    v_ms, _ = min_sum_run(graphs.x, syn, prior, max_iters=30)
    flip_sp = np.asarray(v_sp)[:, 0] >= 0.5
    flip_ms = np.asarray(v_ms)[:, 0] <= 0.0
    assert np.array_equal(flip_sp, flip_ms)
