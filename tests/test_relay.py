"""Relay / ensemble BP (decoder/relay.py): damped-retry repairs on device."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qec_ldpc as q
from qec_ldpc.decoder import BPConfig
from qec_ldpc.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    decode_batch,
)
from qec_ldpc.decoder.min_sum import min_sum_run
from qec_ldpc.decoder.relay import relay_decode_batch
from qec_ldpc.sampling import sample_weight_w_errors


@pytest.fixture(scope="module")
def graphs():
    return CodeGraphs.build(q.construct_code(3, 3, 6, 7, 2, 3))


@pytest.fixture(scope="module")
def hard_syndromes(graphs):
    """A batch heavy enough that plain min-sum fails on many lanes."""
    n = graphs.code.n
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(4), n, 5, 128)
    return (graphs.x.syndrome(xe.astype(jnp.int32)),
            graphs.z.syndrome(ze.astype(jnp.int32)))


def test_damping_zero_matches_undamped(graphs, hard_syndromes):
    """damping=0 everywhere is bit-identical to the undamped update."""
    sx, _ = hard_syndromes
    prior = jnp.float32(2 / 3 * 0.02)
    v0, i0 = min_sum_run(graphs.x, sx, prior, max_iters=15)
    zeros = jnp.zeros((graphs.x.num_edges, sx.shape[-1]), jnp.float32)
    v1, i1 = min_sum_run(graphs.x, sx, prior, max_iters=15, damping=zeros)
    assert int(i0) == int(i1)
    assert np.array_equal(np.asarray(v0), np.asarray(v1))


def test_expand_vars_roundtrip(graphs):
    g = graphs.x
    vals = jnp.arange(g.num_vars, dtype=jnp.float32)[:, None] + 0.5
    e = g.expand_vars(jnp.broadcast_to(vals, (g.num_vars, 3)))
    assert e.shape == (g.num_edges, 3)
    # rolling back to var order recovers B identical copies of the values
    back = np.asarray(g.vn_view(g.to_var(e)))
    for b in range(g.B):
        assert np.array_equal(back[b], np.broadcast_to(np.asarray(vals), (g.num_vars, 3)))


def test_relay_repairs_failures(graphs, hard_syndromes):
    sx, sz = hard_syndromes
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    base = decode_batch(graphs, sx, sz, 0.02, cfg)
    ec0 = np.asarray(base.error_code)
    failed0 = np.count_nonzero(ec0 & (SYNDROME_FAIL_X | SYNDROME_FAIL_Z))
    assert failed0 > 0, "fixture produced no failures; raise the weight"

    res, rx, rz = relay_decode_batch(graphs, sx, sz, 0.02,
                                     jax.random.PRNGKey(7), cfg, retries=16)
    ec = np.asarray(res.error_code)
    failed = np.count_nonzero(ec & (SYNDROME_FAIL_X | SYNDROME_FAIL_Z))
    # most failures repaired (statistically ~all on this small code)
    assert failed < failed0 / 2, (failed0, failed)
    # every repaired/kept decision actually satisfies its syndrome where the
    # flag says so
    dx = np.asarray(res.decisions_x)
    s_hat = np.asarray(graphs.x.syndrome(jnp.asarray(dx, jnp.int32)))
    mism = (s_hat != np.asarray(sx)).any(axis=0)
    assert np.array_equal(mism, (ec & SYNDROME_FAIL_X) != 0)
    # untouched lanes keep the primary decisions
    ok0 = (ec0 & SYNDROME_FAIL_X) == 0
    assert np.array_equal(dx[:, ok0], np.asarray(base.decisions_x)[:, ok0])
    # convergence flags are inherited from the primary decode
    conv_bits = ~np.int64(SYNDROME_FAIL_X | SYNDROME_FAIL_Z)
    assert np.array_equal(ec0 & conv_bits, ec & conv_bits)
    assert int(rx) <= 16 and int(rz) <= 16


def test_run_monte_carlo_relay_modes(graphs):
    """Quality-driver composition: relay-only (lam=-1), OSD-only, and
    relay+OSD all share sample keys with the base run and never lose
    corrected lanes."""
    from qec_ldpc.parallel.montecarlo import (
        run_monte_carlo,
        run_monte_carlo_osd,
    )
    from qec_ldpc.sampling.classify import (
        C_CORRECTED,
        C_SYN_X,
        C_SYN_Z,
        C_TESTED,
    )

    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    kw = dict(seed=7, batch_size=128)
    base, _ = run_monte_carlo(graphs, 4, 256, 0.02, cfg, **kw)
    relay_only, _ = run_monte_carlo_osd(graphs, 4, 256, 0.02, cfg, lam=-1,
                                        relay_retries=8, **kw)
    both, _ = run_monte_carlo_osd(graphs, 4, 256, 0.02, cfg, lam=4,
                                  relay_retries=8, **kw)
    assert relay_only[C_TESTED] == base[C_TESTED] == both[C_TESTED]
    # relay repairs most failures; relay+OSD repairs all
    base_syn = base[C_SYN_X] + base[C_SYN_Z]
    relay_syn = relay_only[C_SYN_X] + relay_only[C_SYN_Z]
    assert relay_syn < base_syn
    assert both[C_SYN_X] == 0 and both[C_SYN_Z] == 0
    assert relay_only[C_CORRECTED] >= base[C_CORRECTED]
    assert both[C_CORRECTED] >= relay_only[C_CORRECTED]


def test_relay_fail_flags_are_exact_reencode(graphs, hard_syndromes):
    """Relay repairs halve the failures, the SYNDROME_FAIL flags stay exact
    re-encode statements after the splice, and the retries' iterations
    accumulate into the honest work counters."""
    sx, sz = hard_syndromes
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    base = decode_batch(graphs, sx, sz, 0.02, cfg)
    ec0 = np.asarray(base.error_code)
    failed0 = np.count_nonzero(ec0 & (SYNDROME_FAIL_X | SYNDROME_FAIL_Z))
    assert failed0 > 0

    res, rx, rz = relay_decode_batch(graphs, sx, sz, 0.02,
                                     jax.random.PRNGKey(7), cfg, retries=16)
    ec = np.asarray(res.error_code)
    failed = np.count_nonzero(ec & (SYNDROME_FAIL_X | SYNDROME_FAIL_Z))
    assert failed < failed0 / 2, (failed0, failed)
    # the SYNDROME_FAIL flags remain exact re-encode statements
    dx = np.asarray(res.decisions_x)
    s_hat = np.asarray(graphs.x.syndrome(jnp.asarray(dx, jnp.int32)))
    mism = (s_hat != np.asarray(sx)).any(axis=0)
    assert np.array_equal(mism, (ec & SYNDROME_FAIL_X) != 0)
    # retry work accumulated into the honest iteration counters
    assert int(res.iter_samples_x) > int(base.iter_samples_x)
    assert int(rx) > 0 and int(rx) <= 16 and int(rz) <= 16


def test_relay_counts_retry_iterations(graphs, hard_syndromes):
    """Honest work accounting: retry iterations are added to
    iter_samples_x/z (regression: relay used to report only the primary
    decode's work)."""
    sx, sz = hard_syndromes
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    base = decode_batch(graphs, sx, sz, 0.02, cfg)
    res, rx, _ = relay_decode_batch(graphs, sx, sz, 0.02,
                                    jax.random.PRNGKey(7), cfg, retries=4)
    assert int(rx) > 0
    assert int(res.iter_samples_x) > int(base.iter_samples_x)


def test_relay_sharded_mesh(graphs):
    """Relay inside the shard_map chunk: pure-device, so it composes with
    the data-parallel mesh (psum counters) — failures drop vs the base
    sharded run with identical sample keys."""
    from qec_ldpc.parallel import make_mesh, run_monte_carlo
    from qec_ldpc.sampling.classify import C_SYN_X, C_SYN_Z, C_TESTED

    mesh = make_mesh()
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    kw = dict(seed=7, batch_size=64, mesh=mesh)
    base, _ = run_monte_carlo(graphs, 4, 256, 0.02, cfg, **kw)
    relay, _ = run_monte_carlo(graphs, 4, 256, 0.02, cfg, relay_retries=8,
                               **kw)
    assert relay[C_TESTED] == base[C_TESTED]
    assert (relay[C_SYN_X] + relay[C_SYN_Z]) < (base[C_SYN_X] + base[C_SYN_Z])


def test_relay_noop_on_clean_batch(graphs):
    n = graphs.code.n
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(0), n, 1, 32)
    sx = graphs.x.syndrome(xe.astype(jnp.int32))
    sz = graphs.z.syndrome(ze.astype(jnp.int32))
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    base = decode_batch(graphs, sx, sz, 0.02, cfg)
    res, rx, rz = relay_decode_batch(graphs, sx, sz, 0.02,
                                     jax.random.PRNGKey(1), cfg, retries=8)
    if not (np.asarray(base.error_code) & 3).any():
        # nothing failed: zero retries executed, outputs bit-identical
        assert int(rx) == 0 and int(rz) == 0
        assert np.array_equal(np.asarray(res.decisions_x),
                              np.asarray(base.decisions_x))
        assert np.array_equal(np.asarray(res.error_code),
                              np.asarray(base.error_code))
