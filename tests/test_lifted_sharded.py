"""Lane-sharded lifted decode (parallel/lifted_sharded.py) vs single-device,
on the 8-virtual-device CPU mesh.

Rolls are exact permutations (ppermute halo exchange) and all arithmetic
stays device-local in the single-device order, so decisions, error codes,
iteration counts AND raw messages are bit-identical for both min-sum and
sum-product — a stronger guarantee than the block-column sharding of
parallel/graph_sharded.py (which reassociates sum-product products).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qec_ldpc.codes import known_bicycle_code, toric_code
from qec_ldpc.decoder import BPConfig
from qec_ldpc.decoder.decode import decode_batch, syndromes_from_errors
from qec_ldpc.parallel import make_mesh
from qec_ldpc.parallel.lifted_sharded import (
    ShardedLiftedGraph,
    make_lifted_sharded_decoder,
)
from qec_ldpc.sampling.errors import sample_depolarizing_errors


def _syndromes(code, graphs, p, batch, seed=0):
    xe, ze = sample_depolarizing_errors(jax.random.PRNGKey(seed), code.n, p,
                                        batch)
    xe, ze = xe.astype(jnp.int32), ze.astype(jnp.int32)
    return syndromes_from_errors(graphs, xe, ze)


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
@pytest.mark.parametrize("num_data,num_graph", [(2, 4), (1, 2), (4, 2)])
def test_toric_matches_single_device(algorithm, num_data, num_graph):
    code = toric_code(4)  # l = 4: G in {2, 4}
    graphs = code.build_graphs()
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    mesh = make_mesh(num_data=num_data, num_graph=num_graph)
    decode = make_lifted_sharded_decoder(mesh, graphs, cfg)

    sx, sz = _syndromes(code, graphs, 0.03, 4 * num_data)
    dx, dz, codes, iters = decode(sx, sz, 0.02)
    ref = decode_batch(graphs, sx, sz, 0.02, cfg)
    assert np.array_equal(np.asarray(dx), np.asarray(ref.decisions_x))
    assert np.array_equal(np.asarray(dz), np.asarray(ref.decisions_z))
    assert np.array_equal(np.asarray(codes), np.asarray(ref.error_code))
    assert np.asarray(iters).shape == (num_data, 2)
    # lockstep early exit: every data shard matches the single-device count
    assert set(np.asarray(iters)[:, 0]) == {int(ref.iters_x)}


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_bicycle_matches_single_device(algorithm):
    code = known_bicycle_code("[[72,12,6]]")  # l = m = 6: G in {2, 3, 6}
    graphs = code.build_graphs()
    cfg = BPConfig(max_iters=15, algorithm=algorithm)
    mesh = make_mesh(num_data=2, num_graph=3)
    decode = make_lifted_sharded_decoder(mesh, graphs, cfg)

    sx, sz = _syndromes(code, graphs, 0.02, 8, seed=3)
    dx, dz, codes, _ = decode(sx, sz, 0.02)
    ref = decode_batch(graphs, sx, sz, 0.02, cfg)
    assert np.array_equal(np.asarray(dx), np.asarray(ref.decisions_x))
    assert np.array_equal(np.asarray(dz), np.asarray(ref.decisions_z))
    assert np.array_equal(np.asarray(codes), np.asarray(ref.error_code))


def test_sharded_roll_roundtrip():
    """to_check(to_var(x)) == x through the halo-exchange rolls."""

    from jax.sharding import PartitionSpec as P
    from qec_ldpc.parallel.mesh import DATA_AXIS, GRAPH_AXIS

    graphs = toric_code(4).build_graphs()
    mesh = make_mesh(num_data=2, num_graph=4)
    adapter = ShardedLiftedGraph(graphs.x, 4)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(graphs.x.num_edges, 8)).astype(np.float32))

    def fn(x_local):
        return adapter.to_check(adapter.to_var(x_local))

    mapped = jax.shard_map(fn, mesh=mesh,
                           in_specs=P(GRAPH_AXIS, DATA_AXIS),
                           out_specs=P(GRAPH_AXIS, DATA_AXIS))
    # the flat edge axis interleaves (edge_block, l, m); reorder bands so
    # each device gets its (edge_block, lc, m) slab contiguously
    E, lc, m, G = graphs.x.num_edge_blocks, adapter.lc, adapter.m, 4
    to_bands = x.reshape(E, G, lc, m, 8).transpose(1, 0, 2, 3, 4).reshape(-1, 8)
    out = np.asarray(mapped(to_bands))
    assert np.array_equal(out, np.asarray(to_bands))


def test_rejects_wrong_shapes():
    graphs = toric_code(4).build_graphs()
    with pytest.raises(ValueError, match="must divide"):
        ShardedLiftedGraph(graphs.x, 3)
    from qec_ldpc.codes import construct_code
    from qec_ldpc.decoder import CodeGraphs

    circ = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    mesh = make_mesh(num_data=4, num_graph=2)
    with pytest.raises(ValueError, match="LiftedGraph"):
        make_lifted_sharded_decoder(mesh, circ, BPConfig(max_iters=5))


def test_weight_one_corrected_full_mesh():
    """(data=2, graph=4): weight-1 X errors decode perfectly on the toric
    code, exercising both mesh axes and the re-encode syndrome check."""
    code = toric_code(4)
    graphs = code.build_graphs()
    mesh = make_mesh(num_data=2, num_graph=4)
    decode = make_lifted_sharded_decoder(mesh, graphs,
                                         BPConfig(max_iters=50,
                                                  algorithm="min-sum"))
    batch = 8
    xe = np.zeros((code.n, batch), dtype=np.int32)
    for b in range(batch):
        xe[(3 * b) % code.n, b] = 1
    sx = graphs.x.syndrome(jnp.asarray(xe))
    sz = jnp.zeros((graphs.z.num_checks, batch), jnp.int32)
    dx, dz, codes, _ = decode(sx, sz, 0.01)
    assert not np.asarray(codes).any()
    # residual error must be a stabilizer (often the exact error on d=4)
    residual = (np.asarray(dx) + xe) % 2
    doubled = np.concatenate([residual, np.zeros_like(residual)], axis=0)
    assert not code.check_logical_error(doubled.T).any()


def test_unsupported_bpconfig_fields_fail_loudly():
    """return_soft configs must not silently drop soft outputs."""
    code = toric_code(4)
    graphs = code.build_graphs()
    mesh = make_mesh(num_data=4, num_graph=2)
    with pytest.raises(ValueError, match="return_soft"):
        make_lifted_sharded_decoder(
            mesh, graphs, BPConfig(max_iters=5, algorithm="min-sum",
                                   return_soft=True))


def test_shape_and_divisibility_validation():
    """ADVICE r2: bad shapes raise a decoder-level message, not a cryptic
    shard_map sharding error."""
    code = toric_code(4)
    graphs = code.build_graphs()
    mesh = make_mesh(num_data=4, num_graph=2)
    decode = make_lifted_sharded_decoder(
        mesh, graphs, BPConfig(max_iters=5, algorithm="min-sum"))
    ok = jnp.zeros((graphs.x.num_checks, 8), jnp.int32)
    with pytest.raises(ValueError, match="GLOBAL"):
        decode(jnp.zeros((7, 8), jnp.int32), ok, 0.01)
    with pytest.raises(ValueError, match="divisible"):
        decode(jnp.zeros((graphs.x.num_checks, 6), jnp.int32),
               jnp.zeros((graphs.z.num_checks, 6), jnp.int32), 0.01)
    with pytest.raises(ValueError, match="batch sizes differ"):
        decode(ok, jnp.zeros((graphs.z.num_checks, 4), jnp.int32), 0.01)
