"""Batched decoder vs the naive NumPy oracle (reference semantics).

Checks message-trajectory agreement, hard decisions, error-code flags, and
early-exit behavior on the small P=7 code.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qec_ldpc.decoder import BPConfig, bp_run, decode_batch
from qec_ldpc.sampling import sample_weight_w_errors

from . import oracle


def _v_to_dense(graph, v, code, sample):
    """Flat edge tensor (num_edges, batch) check-indexed -> dense
    (numVars, numEqs) array with zeros on non-edges, matching the oracle's
    varNodes layout."""
    B, L, P = graph.B, graph.L, graph.P
    dense = np.zeros((code.n, B * P), dtype=np.float32)
    vv = np.asarray(v)[:, sample]
    for b in range(B):
        for l in range(L):
            for r in range(P):
                check = b * P + r
                var = l * P + (int(graph.table[b, l]) + r) % P
                dense[var, check] = vv[(b * L + l) * P + r]
    return dense


@pytest.mark.parametrize("weight,iters", [(1, 1), (2, 3), (4, 7)])
def test_message_trajectory_matches_oracle(small_code, small_graphs, rng, weight, iters):
    """After a fixed number of iterations (no early exit), the vectorized
    messages equal the oracle's within float tolerance."""
    code, graphs = small_code, small_graphs
    n = code.n
    err = np.zeros(n, dtype=np.int64)
    err[rng.choice(n, size=weight, replace=False)] = 1
    syn = code.syndrome_x(err)

    v_oracle, _ = oracle.bp_single(code.pcm_x % 2, syn, 0.05, iters)

    syn_b = jnp.asarray(syn.reshape(-1, 1))
    prior = jnp.float32(2.0 / 3.0 * 0.05)
    v, _ = bp_run(graphs.x, syn_b, prior, max_iters=iters)
    dense = _v_to_dense(graphs.x, v, code, 0)
    np.testing.assert_allclose(dense, v_oracle, rtol=2e-5, atol=2e-6)


def test_full_decode_matches_oracle(small_code, small_graphs, rng):
    """Hard decisions + error codes agree with the oracle across a batch of
    random weight-2 errors (max_iters chosen to exercise both convergence and
    the last-iteration posterior path)."""
    code, graphs = small_code, small_graphs
    n, batch = code.n, 24
    p_phys = 0.05
    max_iters = 15

    xs = np.zeros((n, batch), dtype=np.int64)
    zs = np.zeros((n, batch), dtype=np.int64)
    for b in range(batch):
        xs[rng.choice(n, 2, replace=False), b] = 1
        zs[rng.choice(n, 2, replace=False), b] = 1
    sx = code.syndrome_x(xs.T).T  # (numEqsX, batch)
    sz = code.syndrome_z(zs.T).T

    res = decode_batch(graphs, jnp.asarray(sx), jnp.asarray(sz), p_phys,
                       BPConfig(max_iters=max_iters))
    dx = np.asarray(res.decisions_x)
    dz = np.asarray(res.decisions_z)
    rcs = np.asarray(res.error_code)

    mismatches = 0
    for b in range(batch):
        odx, odz, orc = oracle.decode(code, sx[:, b], sz[:, b], p_phys, max_iters)
        if not (np.array_equal(dx[:, b], odx) and np.array_equal(dz[:, b], odz)
                and rcs[b] == orc):
            mismatches += 1
    # float product-order differences may flip a borderline message on rare
    # samples; demand exact agreement on the overwhelming majority
    assert mismatches <= 1, f"{mismatches}/{batch} samples disagree with oracle"


def test_early_exit_freezes_converged_lanes(small_code, small_graphs):
    """A trivially-decodable lane must hold its converged state while the loop
    would otherwise keep running (per-sample break, DecoderCPU.h:280-291)."""
    code, graphs = small_code, small_graphs
    n = code.n
    easy = np.zeros(n, dtype=np.int64); easy[3] = 1
    syn_easy = code.syndrome_x(easy)
    syn_zero = np.zeros_like(syn_easy)

    batch_syn = jnp.asarray(np.stack([syn_easy, syn_zero], axis=1))
    prior = jnp.float32(2.0 / 3.0 * 0.05)
    v_short, it_short = bp_run(graphs.x, batch_syn, prior, max_iters=11)
    v_long, it_long = bp_run(graphs.x, batch_syn, prior, max_iters=51)
    # both lanes converge quickly -> loop exits at the first passing check
    assert int(it_long) <= 11
    np.testing.assert_array_equal(np.asarray(v_short), np.asarray(v_long))


def test_all_zero_syndrome_decodes_to_zero(small_code, small_graphs):
    code, graphs = small_code, small_graphs
    sx = jnp.zeros((code.num_eqs_x, 4), dtype=jnp.int32)
    sz = jnp.zeros((code.num_eqs_z, 4), dtype=jnp.int32)
    res = decode_batch(graphs, sx, sz, 0.05, BPConfig(max_iters=50))
    assert np.asarray(res.decisions_x).sum() == 0
    assert np.asarray(res.decisions_z).sum() == 0
    assert (np.asarray(res.error_code) == 0).all()


def test_weight_one_errors_all_corrected(small_code, small_graphs):
    code, graphs = small_code, small_graphs
    n, batch = code.n, 128
    key = jax.random.PRNGKey(7)
    xe, ze = sample_weight_w_errors(key, n, 1, batch)
    sx = graphs.x.syndrome(xe.astype(jnp.int32))
    sz = graphs.z.syndrome(ze.astype(jnp.int32))
    res = decode_batch(graphs, sx, sz, 0.02, BPConfig(max_iters=100))
    assert np.array_equal(np.asarray(res.decisions_x), np.asarray(xe))
    assert np.array_equal(np.asarray(res.decisions_z), np.asarray(ze))
    assert (np.asarray(res.error_code) == 0).all()


def test_syndrome_circulant_matches_dense(small_code, small_graphs, rng):
    """Circulant roll-based syndrome == dense mod-2 matvec."""
    code, graphs = small_code, small_graphs
    errs = rng.integers(0, 2, (code.n, 5))
    s_roll = np.asarray(graphs.x.syndrome(jnp.asarray(errs)))
    s_dense = code.syndrome_x(errs.T).T
    assert np.array_equal(s_roll, s_dense % 2)
    s_roll_z = np.asarray(graphs.z.syndrome(jnp.asarray(errs)))
    s_dense_z = code.syndrome_z(errs.T).T
    assert np.array_equal(s_roll_z, s_dense_z % 2)
