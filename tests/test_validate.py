"""Sanitizer layer (decoder/validate.py): checkify float checks + structural
result validation — this framework's slot for the reference's (absent) race/
numerics tooling (SURVEY §5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qec_ldpc as q
from qec_ldpc.decoder import BPConfig
from qec_ldpc.decoder.decode import CodeGraphs, decode_batch
from qec_ldpc.decoder.validate import (
    checked_decode_batch,
    validate_decode_result,
)
from qec_ldpc.sampling import sample_weight_w_errors


@pytest.fixture(scope="module")
def graphs():
    return CodeGraphs.build(q.construct_code(3, 3, 6, 7, 2, 3))


@pytest.fixture(scope="module")
def syndromes(graphs):
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(0), graphs.code.n, 3, 16)
    return (graphs.x.syndrome(xe.astype(jnp.int32)),
            graphs.z.syndrome(ze.astype(jnp.int32)))


def test_healthy_short_decode_passes_float_checks(graphs, syndromes):
    """Before message saturation (~8 iterations on easy syndromes) a healthy
    decode is float-clean end to end."""
    sx, sz = syndromes
    err, res = checked_decode_batch(graphs, sx, sz, 0.02,
                                    BPConfig(max_iters=5))
    err.throw()  # no NaN/Inf/div0 anywhere in the decode
    assert res.decisions_x.shape == (graphs.code.n, 16)


def test_saturation_signature_on_long_runs(graphs, syndromes):
    """Long healthy runs trip the KNOWN-BENIGN signature: a div-by-zero in
    the (masked) VN posterior once messages saturate to exact 0/1 — while
    the actual outputs stay structurally valid."""
    sx, sz = syndromes
    cfg = BPConfig(max_iters=20)
    err, _ = checked_decode_batch(graphs, sx, sz, 0.02, cfg)
    assert err.get() is not None and "division" in err.get()
    res = decode_batch(graphs, sx, sz, 0.02,
                       BPConfig(max_iters=20, return_soft=True))
    assert validate_decode_result(graphs, sx, sz, res) == []


def test_degenerate_prior_is_caught_before_saturation(graphs, syndromes):
    """prior = 1.0 (error_probability = 1.5 with the 2/3 factor) breaks the
    decode within the first iterations — at a max_iters where a healthy
    decode is float-clean."""
    sx, sz = syndromes
    err, _ = checked_decode_batch(graphs, sx, sz, 1.5,
                                  BPConfig(max_iters=5))
    with pytest.raises(Exception, match="nan|inf|division"):
        err.throw()


def test_validate_decode_result_clean(graphs, syndromes):
    sx, sz = syndromes
    res = decode_batch(graphs, sx, sz, 0.02,
                       BPConfig(max_iters=20, return_soft=True))
    assert validate_decode_result(graphs, sx, sz, res) == []


def test_validate_decode_result_detects_tampering(graphs, syndromes):
    import dataclasses

    sx, sz = syndromes
    res = decode_batch(graphs, sx, sz, 0.02,
                       BPConfig(max_iters=20, return_soft=True))
    # flip one decision bit: the re-encoded syndrome no longer matches the
    # SYNDROME_FAIL flag for that lane
    dx = np.asarray(res.decisions_x).copy()
    dx[0, 0] ^= 1
    bad = dataclasses.replace(res, decisions_x=jnp.asarray(dx))
    probs = validate_decode_result(graphs, sx, sz, bad)
    assert any("SYNDROME_FAIL_X" in p for p in probs)
    # non-finite soft output
    soft = np.asarray(res.soft_z).copy()
    soft[3, 3] = np.nan
    bad2 = dataclasses.replace(res, soft_z=jnp.asarray(soft))
    probs2 = validate_decode_result(graphs, sx, sz, bad2)
    assert any("soft_z" in p for p in probs2)
