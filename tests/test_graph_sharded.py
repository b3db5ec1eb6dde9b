"""Tanner-graph-sharded decode (parallel/graph_sharded.py) vs the
single-device decoder, on the 8-virtual-device CPU mesh.

The sharded path reassociates cross-device products, so messages agree to
float tolerance and hard decisions/error codes agree exactly on
non-borderline samples (BASELINE config 5 validation strategy).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qec_ldpc.decoder import BPConfig, decode_batch
from qec_ldpc.parallel import make_mesh
from qec_ldpc.parallel.graph_sharded import make_graph_sharded_decoder
from qec_ldpc.sampling import sample_weight_w_errors


def _random_syndromes(code, graphs, rng, batch, weight=2):
    n = code.n
    xs = np.zeros((n, batch), dtype=np.int64)
    zs = np.zeros((n, batch), dtype=np.int64)
    for b in range(batch):
        xs[rng.choice(n, weight, replace=False), b] = 1
        zs[rng.choice(n, weight, replace=False), b] = 1
    sx = jnp.asarray(code.syndrome_x(xs.T).T)
    sz = jnp.asarray(code.syndrome_z(zs.T).T)
    return sx, sz


@pytest.mark.parametrize("num_data,num_graph", [(1, 2), (2, 3), (1, 6)])
def test_matches_single_device_decode(small_code, small_graphs, rng,
                                      num_data, num_graph):
    code, graphs = small_code, small_graphs
    mesh = make_mesh(num_data=num_data, num_graph=num_graph)
    cfg = BPConfig(max_iters=15)
    decode = make_graph_sharded_decoder(mesh, graphs, cfg)

    batch = 4 * num_data
    sx, sz = _random_syndromes(code, graphs, rng, batch)
    dx, dz, codes, iters = decode(sx, sz, 0.05)
    ref = decode_batch(graphs, sx, sz, 0.05, cfg)

    assert np.array_equal(np.asarray(dx), np.asarray(ref.decisions_x))
    assert np.array_equal(np.asarray(dz), np.asarray(ref.decisions_z))
    assert np.array_equal(np.asarray(codes), np.asarray(ref.error_code))
    assert np.asarray(iters).shape == (num_data, 2)


def test_weight_one_corrected_on_full_mesh(small_code, small_graphs):
    """(data=4, graph=2) mesh: weight-1 errors must be perfectly corrected,
    exercising both axes at once."""
    code, graphs = small_code, small_graphs
    mesh = make_mesh(num_data=4, num_graph=2)
    decode = make_graph_sharded_decoder(mesh, graphs, BPConfig(max_iters=50))

    batch = 16
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(11), code.n, 1, batch)
    sx = graphs.x.syndrome(xe.astype(jnp.int32))
    sz = graphs.z.syndrome(ze.astype(jnp.int32))
    dx, dz, codes, _ = decode(sx, sz, 0.02)
    assert np.array_equal(np.asarray(dx), np.asarray(xe))
    assert np.array_equal(np.asarray(dz), np.asarray(ze))
    assert (np.asarray(codes) == 0).all()


def test_zero_syndrome_zero_decisions(small_code, small_graphs):
    code, graphs = small_code, small_graphs
    mesh = make_mesh(num_data=2, num_graph=2)
    decode = make_graph_sharded_decoder(mesh, graphs, BPConfig(max_iters=20))
    sx = jnp.zeros((code.num_eqs_x, 4), dtype=jnp.int32)
    sz = jnp.zeros((code.num_eqs_z, 4), dtype=jnp.int32)
    dx, dz, codes, _ = decode(sx, sz, 0.05)
    assert np.asarray(dx).sum() == 0 and np.asarray(dz).sum() == 0
    assert (np.asarray(codes) == 0).all()


def test_requires_divisible_columns(small_code, small_graphs):
    mesh = make_mesh(num_data=1, num_graph=4)  # L=6 not divisible by 4
    with pytest.raises(ValueError, match="must divide"):
        make_graph_sharded_decoder(mesh, small_graphs, BPConfig())


@pytest.mark.parametrize("num_data,num_graph", [(1, 2), (2, 3)])
def test_min_sum_bit_exact_vs_single_device(small_code, small_graphs, rng,
                                            num_data, num_graph):
    """Min-sum's cross-shard reduction (min + sign product) is exact under
    any association, so the graph-sharded decode is bit-identical to the
    single-device min-sum path: decisions, error codes, everything."""
    code, graphs = small_code, small_graphs
    mesh = make_mesh(num_data=num_data, num_graph=num_graph)
    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    decode = make_graph_sharded_decoder(mesh, graphs, cfg)

    batch = 4 * num_data
    sx, sz = _random_syndromes(code, graphs, rng, batch)
    dx, dz, codes, _ = decode(sx, sz, 0.05)
    ref = decode_batch(graphs, sx, sz, 0.05, cfg)
    assert np.array_equal(np.asarray(dx), np.asarray(ref.decisions_x))
    assert np.array_equal(np.asarray(dz), np.asarray(ref.decisions_z))
    assert np.array_equal(np.asarray(codes), np.asarray(ref.error_code))


def test_min_sum_weight_one_corrected_on_full_mesh(small_code, small_graphs):
    code, graphs = small_code, small_graphs
    mesh = make_mesh(num_data=4, num_graph=2)
    decode = make_graph_sharded_decoder(
        mesh, graphs, BPConfig(max_iters=50, algorithm="min-sum"))
    batch = 16
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(13), code.n, 1, batch)
    sx = graphs.x.syndrome(xe.astype(jnp.int32))
    sz = graphs.z.syndrome(ze.astype(jnp.int32))
    dx, dz, codes, _ = decode(sx, sz, 0.02)
    assert np.array_equal(np.asarray(dx), np.asarray(xe))
    assert np.array_equal(np.asarray(dz), np.asarray(ze))
    assert (np.asarray(codes) == 0).all()


@pytest.mark.parametrize("num_data,num_graph", [(1, 2), (2, 3)])
def test_layered_bit_exact_vs_single_device(small_code, small_graphs, rng,
                                            num_data, num_graph):
    """Layered min-sum's cross-shard reductions (min + sign product) are
    exact under any association, so the graph-sharded layered decode is
    bit-identical to the single-device layered path."""
    code, graphs = small_code, small_graphs
    mesh = make_mesh(num_data=num_data, num_graph=num_graph)
    cfg = BPConfig(max_iters=15, algorithm="layered-min-sum")
    decode = make_graph_sharded_decoder(mesh, graphs, cfg)

    batch = 4 * num_data
    sx, sz = _random_syndromes(code, graphs, rng, batch)
    dx, dz, codes, _ = decode(sx, sz, 0.05)
    ref = decode_batch(graphs, sx, sz, 0.05, cfg)
    assert np.array_equal(np.asarray(dx), np.asarray(ref.decisions_x))
    assert np.array_equal(np.asarray(dz), np.asarray(ref.decisions_z))
    assert np.array_equal(np.asarray(codes), np.asarray(ref.error_code))


def test_layered_weight_one_corrected_on_full_mesh(small_code, small_graphs):
    code, graphs = small_code, small_graphs
    mesh = make_mesh(num_data=4, num_graph=2)
    decode = make_graph_sharded_decoder(
        mesh, graphs, BPConfig(max_iters=50, algorithm="layered-min-sum"))
    batch = 16
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(17), code.n, 1, batch)
    sx = graphs.x.syndrome(xe.astype(jnp.int32))
    sz = graphs.z.syndrome(ze.astype(jnp.int32))
    dx, dz, codes, _ = decode(sx, sz, 0.02)
    assert np.array_equal(np.asarray(dx), np.asarray(xe))
    assert np.array_equal(np.asarray(dz), np.asarray(ze))
    assert (np.asarray(codes) == 0).all()


def test_unknown_algorithm_rejected(small_graphs):
    mesh = make_mesh(num_data=1, num_graph=2)
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_graph_sharded_decoder(
            mesh, small_graphs, BPConfig(algorithm="bogus"))
