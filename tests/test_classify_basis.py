"""Rank-basis logical test == dense iMinusP test, bit for bit.

The dense test (Quantum_LDPC_Code.h:126-142) and the rank-basis test
(sampling/classify.RankBasisTest) share the same kernel per sector, so every
classification decision must agree exactly — asserted here on both shipped
reference codes (including the file-shipped iMinusP matrix), a BB code, and
the toric code, over random residuals and over full decode pipelines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qec_ldpc.codes import construct_code, known_bicycle_code, toric_code
from qec_ldpc.codes.loader import load_code_file
from qec_ldpc.decoder import BPConfig, CodeGraphs, decode_batch
from qec_ldpc.decoder.decode import syndromes_from_errors
from qec_ldpc.sampling import sample_weight_w_errors
from qec_ldpc.sampling.classify import (
    classify_batch,
    classify_batch_np,
    logical_error_mask,
    logical_error_mask_basis,
    make_rank_basis_test,
)

def _random_residuals(key, two_n, batch):
    # mix of sparse (plausible residuals) and dense random vectors
    r1 = (jax.random.uniform(key, (two_n, batch // 2)) < 0.02).astype(jnp.int32)
    r2 = (jax.random.uniform(jax.random.fold_in(key, 1),
                             (two_n, batch - batch // 2)) < 0.5).astype(jnp.int32)
    return jnp.concatenate([r1, r2], axis=1)


@pytest.mark.parametrize("make_code", [
    lambda: construct_code(3, 3, 6, 7, 2, 3),
    lambda: construct_code(4, 5, 10, 61, 9, 49),
    lambda: known_bicycle_code("[[72,12,6]]"),
    lambda: toric_code(4),
], ids=["qc7", "qc61", "bb72", "toric4"])
def test_mask_bitequal_vs_dense(make_code):
    code = make_code()
    test = make_rank_basis_test(code)
    residual = _random_residuals(jax.random.PRNGKey(0), 2 * code.n, 64)
    dense = np.asarray(logical_error_mask(jnp.asarray(code.i_minus_p), residual))
    basis = np.asarray(logical_error_mask_basis(test, residual))
    np.testing.assert_array_equal(dense, basis)
    # memory claim: basis rows = rank <= num checks << 2n
    assert test.basis_x.shape[0] < code.n
    assert test.basis_x.shape[1] == code.n


def test_mask_bitequal_vs_file_shipped_matrix(small_code_file):
    """The loader code carries the FILE-shipped iMinusP; the basis test is
    built from the PCMs' RREF — same kernel, so classification agrees."""
    code = load_code_file(small_code_file)
    test = make_rank_basis_test(code)
    residual = _random_residuals(jax.random.PRNGKey(7), 2 * code.n, 128)
    dense = np.asarray(logical_error_mask(jnp.asarray(code.i_minus_p), residual))
    basis = np.asarray(logical_error_mask_basis(test, residual))
    np.testing.assert_array_equal(dense, basis)


def test_physical_convention_bitequal():
    code = construct_code(3, 3, 6, 7, 2, 3)
    test = make_rank_basis_test(code, logical_test="physical")
    residual = _random_residuals(jax.random.PRNGKey(3), 2 * code.n, 64)
    dense = np.asarray(logical_error_mask(
        jnp.asarray(code.i_minus_p_physical), residual))
    basis = np.asarray(logical_error_mask_basis(test, residual))
    np.testing.assert_array_equal(dense, basis)


def test_classify_batch_counters_bitequal_end_to_end():
    """Full pipeline: sample -> decode -> classify, dense vs basis counters."""
    code = construct_code(3, 3, 6, 7, 2, 3)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code)
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(5), code.n, 3, 256)
    xe, ze = xe.astype(jnp.int32), ze.astype(jnp.int32)
    sx, sz = syndromes_from_errors(graphs, xe, ze)
    res = decode_batch(graphs, sx, sz, 0.02, BPConfig(max_iters=30))
    dx = res.decisions_x.astype(jnp.int32)
    dz = res.decisions_z.astype(jnp.int32)
    dense = np.asarray(classify_batch(jnp.asarray(code.i_minus_p),
                                      xe, ze, dx, dz, res.error_code))
    basis = np.asarray(classify_batch(test, xe, ze, dx, dz, res.error_code))
    np.testing.assert_array_equal(dense, basis)
    # host mirror agrees too (OSD path)
    host = classify_batch_np(test, np.asarray(xe), np.asarray(ze),
                             np.asarray(dx), np.asarray(dz),
                             np.asarray(res.error_code))
    np.testing.assert_array_equal(dense, host)


def test_large_p_code_classifies_without_dense_matrix():
    """A P=521 code's dense iMinusP would be (2n)^2 = 10420^2 ~ 108 MB int8
    (and O(n^2) to build); the rank-basis test needs only rank x n."""
    from qec_ldpc.codes.construction import find_code_params

    pairs = find_code_params(4, 5, 10, 521, count=1)
    assert pairs, "no (sigma, tau) found for P=521"
    s, t = pairs[0]
    code = construct_code(4, 5, 10, 521, s, t)
    test = make_rank_basis_test(code)
    assert test.basis_x.shape[1] == code.n == 5210
    assert test.basis_x.shape[0] <= code.num_eqs_x
    residual = _random_residuals(jax.random.PRNGKey(11), 2 * code.n, 8)
    mask = np.asarray(logical_error_mask_basis(test, residual))
    assert mask.shape == (8,)
    # a genuine stabilizer row reduces to zero -> harmless
    stab = jnp.concatenate([
        jnp.asarray(code.pcm_x[[0, 37]].T, jnp.int32),
        jnp.zeros((code.n, 2), jnp.int32)], axis=0)
    np.testing.assert_array_equal(
        np.asarray(logical_error_mask_basis(test, stab)), [False, False])


def test_invalid_logical_test_rejected_for_all_families():
    from qec_ldpc.codes import known_bicycle_code

    for code in (construct_code(3, 3, 6, 7, 2, 3),
                 known_bicycle_code("[[72,12,6]]")):
        with pytest.raises(ValueError, match="unknown logical_test"):
            make_rank_basis_test(code, logical_test="physcal")
