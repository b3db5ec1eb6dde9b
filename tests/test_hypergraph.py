"""Hypergraph-product codes (codes/hypergraph.py) — incl. the toric code.

Covers: [[2d²,2,d]] toric parameters, k = 2·k1·k2 for general circulant
factors, CSS orthogonality, graph-vs-dense syndrome parity, end-to-end
decode + classification on the lifted stack, sum-product parity with the
dense oracle, OSD repair of BP failures (BP alone struggles on the degenerate
toric code), and the CLI code specs.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qec_ldpc.codes import hgp_code, toric_code
from qec_ldpc.codes.construction import gf2_rref
from qec_ldpc.decoder import BPConfig
from qec_ldpc.decoder.decode import decode_batch, syndromes_from_errors
from qec_ldpc.sampling.classify import classify_batch
from qec_ldpc.sampling.errors import sample_depolarizing_errors


@pytest.fixture(scope="module")
def toric4():
    return toric_code(4)


@pytest.fixture(scope="module")
def toric4_graphs(toric4):
    return toric4.build_graphs()


# -- construction ------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 3, 4, 5])
def test_toric_parameters(d):
    code = toric_code(d)
    assert code.n == 2 * d * d
    assert code.k_logical == 2
    # both stabilizer types have rank d^2 - 1 and uniform row weight 4
    assert len(gf2_rref(code.hx_stab)[1]) == d * d - 1
    assert set(code.hx_stab.sum(1)) == {4}
    assert set(code.hz_stab.sum(1)) == {4}


def test_hgp_k_equals_2_k1_k2():
    """k = 2·k1·k2 for the HGP of square circulant factors."""
    code = hgp_code(7, 7, "1 + x + x3", "1 + y + y3")
    circ = np.array([[1 if (j - i) % 7 in (0, 1, 3) else 0 for j in range(7)]
                     for i in range(7)], dtype=np.uint8)
    k1 = 7 - len(gf2_rref(circ)[1])
    assert code.n == 98
    assert code.k_logical == 2 * k1 * k1 == 18


def test_css_orthogonality(toric4):
    prod = (toric4.hx_stab.astype(np.int64)
            @ toric4.hz_stab.T.astype(np.int64)) % 2
    assert not prod.any()


def test_block_structure(toric4):
    """hx = [h1⊗I | I⊗h2^T] really carries the Kronecker structure."""
    d = 4
    h = np.array([[1 if (j - i) % d in (0, 1) else 0 for j in range(d)]
                  for i in range(d)], dtype=np.uint8)
    left = np.kron(h, np.eye(d, dtype=np.uint8))
    right = np.kron(np.eye(d, dtype=np.uint8), h.T)
    assert np.array_equal(toric4.hx_stab[:, :16], left)
    assert np.array_equal(toric4.hx_stab[:, 16:], right)


def test_unequal_weights_rejected():
    with pytest.raises(ValueError, match="uniform var degrees"):
        hgp_code(5, 5, "1 + x", "1 + y + y2")


def test_poly_parser_strict():
    with pytest.raises(ValueError, match="bad term"):
        hgp_code(5, 5, "1 + z2", "1 + y")
    with pytest.raises(ValueError, match="duplicate"):
        hgp_code(5, 5, "1 + x5", "1 + y")  # x5 ≡ 1 mod 5


def test_i_minus_p_semantics(toric4):
    """Stabilizer rows are harmless; a weight-1 residual is logical-free only
    if it is a stabilizer (weight-1 never is on the torus)."""
    n = toric4.n
    for row in toric4.hx_stab[:4]:
        doubled = np.concatenate([row, np.zeros(n, dtype=row.dtype)])
        assert not toric4.check_logical_error(doubled)
    for row in toric4.hz_stab[:4]:
        doubled = np.concatenate([np.zeros(n, dtype=row.dtype), row])
        assert not toric4.check_logical_error(doubled)
    e = np.zeros(2 * n, dtype=np.uint8)
    e[0] = 1
    assert toric4.check_logical_error(e)


# -- lifted-graph layout ------------------------------------------------------

def test_syndrome_matches_dense(toric4, toric4_graphs):
    rng = np.random.default_rng(2)
    err = rng.integers(0, 2, size=(toric4.n, 8)).astype(np.int32)
    s_graph = np.asarray(toric4_graphs.x.syndrome(jnp.asarray(err)))
    s_dense = (toric4.pcm_x.astype(np.int64) @ err) % 2
    assert np.array_equal(s_graph, s_dense)
    s_graph_z = np.asarray(toric4_graphs.z.syndrome(jnp.asarray(err)))
    s_dense_z = (toric4.pcm_z.astype(np.int64) @ err) % 2
    assert np.array_equal(s_graph_z, s_dense_z)


def test_dense_pcm_roundtrip(toric4, toric4_graphs):
    assert np.array_equal(toric4_graphs.x.dense_pcm(), toric4.pcm_x % 2)
    assert np.array_equal(toric4_graphs.z.dense_pcm(), toric4.pcm_z % 2)


# -- decode -------------------------------------------------------------------

def test_toric_decode_end_to_end(toric4, toric4_graphs):
    batch = 128
    key = jax.random.PRNGKey(3)
    xe, ze = sample_depolarizing_errors(key, toric4.n, 0.01, batch)
    xe, ze = xe.astype(jnp.int32), ze.astype(jnp.int32)
    sx, sz = syndromes_from_errors(toric4_graphs, xe, ze)
    cfg = BPConfig(max_iters=30, algorithm="min-sum")
    res = decode_batch(toric4_graphs, sx, sz, 0.01, cfg)
    counters = np.asarray(classify_batch(
        jnp.asarray(toric4.i_minus_p), xe, ze,
        res.decisions_x.astype(jnp.int32), res.decisions_z.astype(jnp.int32),
        res.error_code))
    assert counters[0] == batch
    # p=0.01 on [[32,2,4]]: most samples correct (degeneracy handled by the
    # physical logical test: residual-in-stabilizer-rowspace == corrected)
    assert counters[3] >= int(0.9 * batch)
    assert counters[3] + counters[6] <= batch


def test_toric_sum_product_matches_oracle(toric4, toric4_graphs):
    """Lifted-graph sum-product on the toric code == the dense NumPy oracle
    (decisions and error codes exactly)."""
    from . import oracle

    rng = np.random.default_rng(5)
    batch = 4
    xe = (rng.random((toric4.n, batch)) < 0.05).astype(np.int32)
    ze = (rng.random((toric4.n, batch)) < 0.05).astype(np.int32)
    sx, sz = syndromes_from_errors(toric4_graphs, jnp.asarray(xe),
                                   jnp.asarray(ze))
    res = decode_batch(toric4_graphs, sx, sz, 0.02, BPConfig(max_iters=15))
    sx, sz = np.asarray(sx), np.asarray(sz)
    hx, hz = toric4.pcm_x % 2, toric4.pcm_z % 2
    dense = types.SimpleNamespace(pcm_x=hx, pcm_z=hz,
                                  syndrome_x=lambda e: hx @ e,
                                  syndrome_z=lambda e: hz @ e)
    for b in range(batch):
        dx, dz, rc = oracle.decode(dense, sx[:, b], sz[:, b], 0.02, 15)
        assert np.array_equal(np.asarray(res.decisions_x)[:, b], dx)
        assert np.array_equal(np.asarray(res.decisions_z)[:, b], dz)
        assert int(np.asarray(res.error_code)[b]) == rc


def test_toric_osd_repairs_bp_failures(toric4, toric4_graphs):
    """BP alone fails often on the degenerate toric code (split beliefs on
    symmetric error cosets); OSD clears every syndrome failure."""
    from qec_ldpc.decoder.osd import CSSPostprocessor
    from qec_ldpc.sampling.classify import classify_batch_np

    batch = 64
    key = jax.random.PRNGKey(7)
    xe, ze = sample_depolarizing_errors(key, toric4.n, 0.04, batch)
    xe, ze = xe.astype(jnp.int32), ze.astype(jnp.int32)
    sx, sz = syndromes_from_errors(toric4_graphs, xe, ze)
    cfg = BPConfig(max_iters=30, algorithm="min-sum", return_soft=True)
    res = decode_batch(toric4_graphs, sx, sz, 0.02, cfg)
    before = classify_batch_np(
        toric4.i_minus_p, np.asarray(xe), np.asarray(ze),
        np.asarray(res.decisions_x), np.asarray(res.decisions_z),
        np.asarray(res.error_code))
    dx, dz, code_bits = CSSPostprocessor(toric4_graphs, lam=8).apply(
        sx, sz, res)
    after = classify_batch_np(
        toric4.i_minus_p, np.asarray(xe), np.asarray(ze),
        dx, dz, code_bits)
    # no syndrome failures survive OSD, and corrected count never drops
    assert after[4] == 0 and after[5] == 0
    assert after[3] >= before[3]


# -- harness integration -------------------------------------------------------

def test_cli_code_specs():
    from qec_ldpc.harness.cli import load_code_and_graphs

    code, graphs = load_code_and_graphs("toric:3")
    assert code.n == 18 and code.k_logical == 2
    assert graphs.x.num_checks == 9

    code2, _ = load_code_and_graphs("hgp:n1=3,n2=3,h1=1+x,h2=1+y")
    assert str(code2) == str(toric_code(3))
