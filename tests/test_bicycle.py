"""Bivariate bicycle codes + lifted-graph layout tests.

Covers: published (n, k) parameters, CSS orthogonality, lifted-graph routing
parity vs CirculantGraph (bit-identical BP), graph-vs-dense syndrome parity,
end-to-end decode + classification, lifted sum-product against the dense
oracle, and relay/OSD repair on a BB code.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qec_ldpc.codes.bicycle import KNOWN_CODES, bicycle_code, known_bicycle_code
from qec_ldpc.decoder import BPConfig
from qec_ldpc.decoder.decode import decode_batch, syndromes_from_errors
from qec_ldpc.decoder.layout import CirculantGraph
from qec_ldpc.decoder.lifted import LiftedGraph
from qec_ldpc.decoder.min_sum import min_sum_run
from qec_ldpc.decoder.sum_product import bp_run
from qec_ldpc.sampling.classify import classify_batch
from qec_ldpc.sampling.errors import sample_depolarizing_errors


@pytest.fixture(scope="module")
def gross():
    return known_bicycle_code("[[144,12,12]]")


@pytest.fixture(scope="module")
def gross_graphs(gross):
    return gross.build_graphs()


# -- construction ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(KNOWN_CODES))
def test_known_codes_parameters(name):
    code = known_bicycle_code(name)
    n, k = (int(x) for x in name.strip("[]").split(",")[:2])
    assert code.n == n
    assert code.k_logical == k


def test_css_orthogonality(gross):
    prod = (gross.hx_stab.astype(np.int64) @ gross.hz_stab.T.astype(np.int64)) % 2
    assert not prod.any()


def test_transpose_blocks(gross):
    """hz_stab really is [B^T | A^T] of hx_stab = [A | B]."""
    P = gross.P
    a = gross.hx_stab[:, :P]
    b = gross.hx_stab[:, P:]
    assert np.array_equal(gross.hz_stab[:, :P], b.T)
    assert np.array_equal(gross.hz_stab[:, P:], a.T)


def test_i_minus_p_annihilates_stabilizers(gross):
    """Rows of H_X (x-sector stabilizers) are harmless; a weight-1 x error is
    not (d = 12 >> 1)."""
    n = gross.n
    for row in gross.hx_stab[:5]:
        doubled = np.concatenate([row, np.zeros(n, dtype=row.dtype)])
        assert not gross.check_logical_error(doubled)
    e = np.zeros(2 * n, dtype=np.uint8)
    e[3] = 1
    assert gross.check_logical_error(e)


# -- lifted-graph layout ------------------------------------------------------

def test_lifted_equals_circulant_bitwise(small_code):
    """A circulant code expressed as a LiftedGraph decodes bit-identically."""
    gc = CirculantGraph.from_table(small_code.hc, small_code.P)
    gl = LiftedGraph.from_circulant(small_code.hc, small_code.P)
    rng = np.random.default_rng(0)
    err = rng.integers(0, 2, size=(gc.num_vars, 16)).astype(np.int32)
    s1 = np.asarray(gc.syndrome(jnp.asarray(err)))
    s2 = np.asarray(gl.syndrome(jnp.asarray(err)))
    assert np.array_equal(s1, s2)
    syn = jnp.asarray(s1)
    v1, n1 = bp_run(gc, syn, jnp.float32(0.02), 25)
    v2, n2 = bp_run(gl, syn, jnp.float32(0.02), 25)
    assert bool(jnp.all(v1 == v2)) and int(n1) == int(n2)
    m1, _ = min_sum_run(gc, syn, jnp.float32(0.02), 25)
    m2, _ = min_sum_run(gl, syn, jnp.float32(0.02), 25)
    assert bool(jnp.all(m1 == m2))


def test_lifted_roundtrip_and_views(gross_graphs):
    g = gross_graphs.x
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(g.num_edges, 8)).astype(np.float32))
    assert bool(jnp.all(g.to_check(g.to_var(x)) == x))
    assert g.cn_view(x).shape == (g.num_check_blocks, g.check_degree, g.P * 8)
    assert g.vn_view(g.to_var(x)).shape == (g.var_degree, g.num_vars, 8)


def test_lifted_syndrome_matches_dense(gross, gross_graphs):
    rng = np.random.default_rng(2)
    err = rng.integers(0, 2, size=(gross.n, 8)).astype(np.int32)
    s_graph = np.asarray(gross_graphs.x.syndrome(jnp.asarray(err)))
    s_dense = (gross.pcm_x.astype(np.int64) @ err) % 2
    assert np.array_equal(s_graph, s_dense)
    s_graph_z = np.asarray(gross_graphs.z.syndrome(jnp.asarray(err)))
    s_dense_z = (gross.pcm_z.astype(np.int64) @ err) % 2
    assert np.array_equal(s_graph_z, s_dense_z)


def test_lifted_dense_pcm_roundtrip(gross, gross_graphs):
    assert np.array_equal(gross_graphs.x.dense_pcm(), gross.pcm_x % 2)
    assert np.array_equal(gross_graphs.z.dense_pcm(), gross.pcm_z % 2)


def test_nonuniform_degrees_rejected():
    with pytest.raises(ValueError, match="check degrees"):
        LiftedGraph.build(2, 2, (5,), [(0, 0, 1), (0, 1, 2), (1, 0, 3)])


# -- decode -------------------------------------------------------------------

def test_bicycle_decode_end_to_end(gross, gross_graphs):
    batch = 128
    key = jax.random.PRNGKey(3)
    xe, ze = sample_depolarizing_errors(key, gross.n, 0.01, batch)
    xe, ze = xe.astype(jnp.int32), ze.astype(jnp.int32)
    sx, sz = syndromes_from_errors(gross_graphs, xe, ze)
    cfg = BPConfig(max_iters=60, algorithm="min-sum")
    res = decode_batch(gross_graphs, sx, sz, 0.01, cfg)
    counters = np.asarray(classify_batch(
        jnp.asarray(gross.i_minus_p), xe, ze,
        res.decisions_x.astype(jnp.int32), res.decisions_z.astype(jnp.int32),
        res.error_code))
    assert counters[0] == batch
    # p=0.01 is far below the BB threshold: expect a large corrected fraction
    assert counters[3] >= int(0.9 * batch)
    # classification lattice invariant: corrected + logical + syndrome-failed
    # partitions the batch (a lane can fail both X and Z, hence >=)
    assert counters[3] + counters[6] <= batch


def test_layered_rejects_lifted(gross_graphs):
    cfg = BPConfig(max_iters=10, algorithm="layered-min-sum")
    sx = jnp.zeros((gross_graphs.x.num_checks, 8), jnp.int32)
    sz = jnp.zeros((gross_graphs.z.num_checks, 8), jnp.int32)
    with pytest.raises(ValueError, match="layered-min-sum requires"):
        decode_batch(gross_graphs, sx, sz, 0.01, cfg)


def test_lifted_sum_product_matches_oracle(gross, gross_graphs):
    """Lifted-graph sum-product decode == the dense NumPy oracle (messages
    to float tolerance, decisions and error codes exactly)."""
    from . import oracle

    rng = np.random.default_rng(8)
    batch = 3
    xe = (rng.random((gross.n, batch)) < 0.02).astype(np.int32)
    ze = (rng.random((gross.n, batch)) < 0.02).astype(np.int32)
    sx, sz = syndromes_from_errors(gross_graphs, jnp.asarray(xe),
                                   jnp.asarray(ze))
    res = decode_batch(gross_graphs, sx, sz, 0.02, BPConfig(max_iters=12))
    sx, sz = np.asarray(sx), np.asarray(sz)
    hx, hz = gross.pcm_x % 2, gross.pcm_z % 2
    dense = types.SimpleNamespace(pcm_x=hx, pcm_z=hz,
                                  syndrome_x=lambda e: hx @ e,
                                  syndrome_z=lambda e: hz @ e)
    for b in range(batch):
        dx, dz, rc = oracle.decode(dense, sx[:, b], sz[:, b], 0.02, 12)
        assert np.array_equal(np.asarray(res.decisions_x)[:, b], dx)
        assert np.array_equal(np.asarray(res.decisions_z)[:, b], dz)
        assert int(np.asarray(res.error_code)[b]) == rc


# -- harness integration -------------------------------------------------------

def test_cli_code_specs():
    from qec_ldpc.harness.cli import load_code_and_graphs

    code, graphs = load_code_and_graphs("bb:[[72,12,6]]")
    assert code.n == 72 and code.k_logical == 12
    assert graphs.x.num_checks == 36

    code2, _ = load_code_and_graphs("bb:l=6,m=6,A=x3+y+y2,B=y3+x+x2")
    assert str(code2) == str(code)

    code3, graphs3 = load_code_and_graphs("qc:3,3,6,7,2,3")
    assert code3.n == 42
    assert graphs3.x.num_checks == 21


# -- repair stack on a BB code -------------------------------------------------

def test_bicycle_osd_repairs_failures(gross, gross_graphs):
    """At heavier noise BP alone leaves syndrome failures; OSD clears them."""
    from qec_ldpc.decoder.osd import CSSPostprocessor
    from qec_ldpc.sampling.classify import classify_batch_np

    batch = 128
    key = jax.random.PRNGKey(11)
    xe, ze = sample_depolarizing_errors(key, gross.n, 0.05, batch)
    xe, ze = xe.astype(jnp.int32), ze.astype(jnp.int32)
    sx, sz = syndromes_from_errors(gross_graphs, xe, ze)
    cfg = BPConfig(max_iters=60, algorithm="min-sum", return_soft=True)
    res = decode_batch(gross_graphs, sx, sz, 0.05, cfg)
    before = classify_batch_np(gross.i_minus_p, np.asarray(xe), np.asarray(ze),
                               np.asarray(res.decisions_x),
                               np.asarray(res.decisions_z),
                               np.asarray(res.error_code))
    dx, dz, ec = CSSPostprocessor(gross_graphs, lam=0).apply(
        np.asarray(sx), np.asarray(sz), res)
    after = classify_batch_np(gross.i_minus_p, np.asarray(xe), np.asarray(ze),
                              dx, dz, ec)
    # OSD output always satisfies the syndrome: no syndrome failures remain
    assert after[4] == 0 and after[5] == 0
    assert after[3] >= before[3]  # corrected count can only improve


def test_bicycle_relay_runs(gross, gross_graphs):
    from qec_ldpc.decoder.relay import relay_decode_batch

    batch = 64
    key = jax.random.PRNGKey(13)
    xe, ze = sample_depolarizing_errors(key, gross.n, 0.05, batch)
    xe, ze = xe.astype(jnp.int32), ze.astype(jnp.int32)
    sx, sz = syndromes_from_errors(gross_graphs, xe, ze)
    cfg = BPConfig(max_iters=40, algorithm="min-sum")
    res0 = decode_batch(gross_graphs, sx, sz, 0.05, cfg)
    res, rx, rz = relay_decode_batch(gross_graphs, sx, sz, 0.05,
                                     jax.random.PRNGKey(1), cfg, retries=4)
    fails0 = int(np.sum(np.asarray(res0.error_code) & 3 != 0))
    fails1 = int(np.sum(np.asarray(res.error_code) & 3 != 0))
    assert fails1 <= fails0
    # repaired lanes really satisfy their syndromes
    sx_hat = np.asarray(gross_graphs.x.syndrome(res.decisions_x.astype(jnp.int32)))
    ok = ~(np.asarray(res.error_code) & 1).astype(bool)
    assert np.array_equal(sx_hat[:, ok], np.asarray(sx)[:, ok])


# -- code search ----------------------------------------------------------------

def test_lifted_4cycle_detector_matches_bfs_girth(gross_graphs):
    from qec_ldpc.codes.analysis import tanner_girth
    from qec_ldpc.codes.bicycle import bicycle_code, lifted_has_4cycles

    assert not lifted_has_4cycles(gross_graphs.z)
    assert tanner_girth(gross_graphs.z.dense_pcm(), cap=6) >= 6
    bad = bicycle_code(6, 6, "x1 + x2 + y1", "y2 + x3 + x4").build_graphs().z
    assert lifted_has_4cycles(bad)
    assert tanner_girth(bad.dense_pcm(), cap=4) == 4


def test_find_bicycle_codes_recovers_published():
    """The BB(6,6) ansatz scan at min_k=12 finds the published [[72,12,6]]."""
    from qec_ldpc.codes.bicycle import find_bicycle_codes

    pub = known_bicycle_code("[[72,12,6]]")
    hits = find_bicycle_codes(6, 6, count=200, min_k=12)
    assert hits, "no k=12 girth-6 BB(6,6) codes found"
    assert all(h.k_logical >= 12 for h in hits)
    assert any(h.a_terms == pub.a_terms and h.b_terms == pub.b_terms
               for h in hits)


def test_polynomial_spec_typos_raise():
    """_mono is strict: unknown variables / dangling '+' fail loudly instead
    of silently parsing as the constant monomial (a different code)."""
    with pytest.raises(ValueError, match="bad monomial"):
        bicycle_code(12, 6, "x3 + y + z2", "y3 + x + x2")
    with pytest.raises(ValueError, match="bad character"):
        bicycle_code(12, 6, "x3 + y + y2z", "y3 + x + x2")
    with pytest.raises(ValueError, match="bad monomial"):
        bicycle_code(12, 6, "x3 + y +", "y3 + x + x2")
