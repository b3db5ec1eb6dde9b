"""Multi-device tests on the 8-way virtual CPU mesh (conftest forces
xla_force_host_platform_device_count=8)."""

import jax
import numpy as np
import pytest

from qec_ldpc.decoder import BPConfig
from qec_ldpc.parallel import DATA_AXIS, make_mesh, run_monte_carlo
from qec_ldpc.sampling import C_CORRECTED, C_TESTED, NUM_COUNTERS


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape[DATA_AXIS] == 8
    mesh2 = make_mesh(num_data=4, num_graph=2)
    assert mesh2.shape == {"data": 4, "graph": 2}
    with pytest.raises(ValueError):
        make_mesh(num_data=16, num_graph=1)


def test_sharded_monte_carlo_runs_and_is_deterministic(small_graphs):
    mesh = make_mesh()
    cfg = BPConfig(max_iters=30)
    counters1, iters1 = run_monte_carlo(
        small_graphs, weight=2, count=256, error_probability=0.03,
        cfg=cfg, seed=99, batch_size=128, mesh=mesh)
    counters2, iters2 = run_monte_carlo(
        small_graphs, weight=2, count=256, error_probability=0.03,
        cfg=cfg, seed=99, batch_size=128, mesh=mesh)
    assert counters1.shape == (NUM_COUNTERS,)
    assert counters1[C_TESTED] == 256
    np.testing.assert_array_equal(counters1, counters2)
    assert iters1 == iters2
    # weight-2 errors on this small code at max_iters=30 decode more often
    # than not (syndrome failures are common at this scale — the reference's
    # own small-code golden runs sit near 60-80% corrected)
    assert counters1[C_CORRECTED] > 0.5 * counters1[C_TESTED]


def test_single_vs_multi_device_statistics_agree(small_graphs):
    """Sample partitioning differs between device layouts (documented), but
    the statistics must agree within Monte-Carlo tolerance."""
    cfg = BPConfig(max_iters=30)
    c_single, _ = run_monte_carlo(
        small_graphs, weight=2, count=1024, error_probability=0.03,
        cfg=cfg, seed=5, batch_size=256, mesh=None)
    c_mesh, _ = run_monte_carlo(
        small_graphs, weight=2, count=1024, error_probability=0.03,
        cfg=cfg, seed=5, batch_size=256, mesh=make_mesh())
    assert c_single[C_TESTED] == c_mesh[C_TESTED] == 1024
    f1 = c_single[C_CORRECTED] / c_single[C_TESTED]
    f2 = c_mesh[C_CORRECTED] / c_mesh[C_TESTED]
    # binomial 4-sigma band
    sigma = np.sqrt(max(f1 * (1 - f1), 0.01) / 1024)
    assert abs(f1 - f2) < 4 * sigma + 0.02


def test_resume_produces_identical_counters(small_graphs):
    """start_chunk/init_counters replay must give the same totals as an
    uninterrupted run (chunk keys depend only on (seed, chunk index))."""
    cfg = BPConfig(max_iters=20)
    full, full_iters = run_monte_carlo(
        small_graphs, weight=2, count=512, error_probability=0.03,
        cfg=cfg, seed=11, batch_size=128, mesh=None)

    # interrupted after 2 of 4 chunks
    chunks = []
    def record(c, num, counters, iters):
        chunks.append((c, counters.copy(), iters))
    part1, _ = run_monte_carlo(
        small_graphs, weight=2, count=256, error_probability=0.03,
        cfg=cfg, seed=11, batch_size=128, mesh=None, progress=record)
    resumed, _ = run_monte_carlo(
        small_graphs, weight=2, count=512, error_probability=0.03,
        cfg=cfg, seed=11, batch_size=128, mesh=None,
        start_chunk=2, init_counters=part1)
    np.testing.assert_array_equal(full, resumed)


def test_steps_per_call_identical_statistics(small_graphs):
    """Scanning chunks on device (steps_per_call > 1) must produce exactly
    the counters of single-chunk dispatches, single-device and sharded."""
    cfg = BPConfig(max_iters=20)
    for mesh in (None, make_mesh()):
        one, it_one = run_monte_carlo(
            small_graphs, weight=2, count=512, error_probability=0.03,
            cfg=cfg, seed=21, batch_size=128, mesh=mesh, steps_per_call=1)
        scanned, it_scan = run_monte_carlo(
            small_graphs, weight=2, count=512, error_probability=0.03,
            cfg=cfg, seed=21, batch_size=128, mesh=mesh, steps_per_call=3)
        np.testing.assert_array_equal(one, scanned)
        assert it_one == it_scan


def test_logical_test_override(small_graphs):
    """run_monte_carlo with the physical i_minus_p never reports MORE logical
    errors than the reference convention on the same seed (the reference
    convention counts genuine stabilizers as logical)."""
    import numpy as np

    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.parallel.montecarlo import run_monte_carlo

    cfg = BPConfig(max_iters=30)
    kw = dict(weight=4, count=256, error_probability=0.02, cfg=cfg, seed=9,
              batch_size=64)
    ref, _ = run_monte_carlo(small_graphs, **kw)
    phy, _ = run_monte_carlo(
        small_graphs, i_minus_p=small_graphs.code.i_minus_p_physical, **kw)
    ref, phy = np.asarray(ref), np.asarray(phy)
    assert ref[0] == phy[0]
    assert np.array_equal(ref[4:6], phy[4:6])  # syndrome fails identical
    assert phy[6] <= ref[6]                    # logical count can only drop
    assert phy[3] >= ref[3]                    # corrected can only grow


def test_dynamic_weight_sampler():
    """sample_weight_w_errors_dynamic: weight is a runtime value (one
    compiled program per sweep); at weight == w_max it is bit-identical to
    the static sampler, and masked slots only ever reduce the error."""
    import jax
    import jax.numpy as jnp

    from qec_ldpc.sampling import (
        sample_weight_w_errors,
        sample_weight_w_errors_dynamic,
    )

    key = jax.random.PRNGKey(5)
    n, w_max, batch = 42, 12, 64
    xs, zs = sample_weight_w_errors(key, n, w_max, batch)
    xd, zd = sample_weight_w_errors_dynamic(key, n, jnp.int32(w_max), w_max,
                                            batch)
    np.testing.assert_array_equal(np.asarray(xs), np.asarray(xd))
    np.testing.assert_array_equal(np.asarray(zs), np.asarray(zd))
    # lower weights: subset support and monotone mean effective weight
    means = []
    for w in (1, 4, 8, 12):
        xw, zw = sample_weight_w_errors_dynamic(key, n, jnp.int32(w), w_max,
                                                batch)
        sup = np.asarray(xw | zw)
        full = np.asarray(xs | zs)
        assert ((sup == 1) <= (full == 1)).all()  # support subset of w_max's
        means.append(sup.sum() / batch)
    assert means == sorted(means)
    assert means[0] <= 1.0 and means[-1] <= w_max


def test_dynamic_weight_matches_static_at_cap(small_graphs):
    """Dynamic-weight mode (r4): a whole weight sweep shares ONE compiled
    program.  At weight == weight_cap the dynamic sampler's draws are
    bit-identical to the static sampler, so the counters must match
    exactly; below the cap the stream differs but statistics must be
    sane."""
    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.parallel import run_monte_carlo

    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    static, it_s = run_monte_carlo(small_graphs, 8, 256, 0.02, cfg, seed=5,
                                   batch_size=128)
    dynamic, it_d = run_monte_carlo(small_graphs, 8, 256, 0.02, cfg, seed=5,
                                    batch_size=128, weight_cap=8)
    np.testing.assert_array_equal(static, dynamic)
    assert it_s == it_d
    # below the cap: same program, different weight operand
    low, _ = run_monte_carlo(small_graphs, 2, 256, 0.02, cfg, seed=5,
                             batch_size=128, weight_cap=8)
    assert low[0] == 256
    assert low[3] > static[3]  # weight 2 corrects far more than weight 8


def test_dynamic_weight_sharded_matches_static_at_cap(small_graphs):
    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.parallel import make_mesh, run_monte_carlo

    mesh = make_mesh(num_data=8)
    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    static, _ = run_monte_carlo(small_graphs, 8, 256, 0.02, cfg, seed=5,
                                batch_size=128, mesh=mesh)
    dynamic, _ = run_monte_carlo(small_graphs, 8, 256, 0.02, cfg, seed=5,
                                 batch_size=128, mesh=mesh, weight_cap=8)
    np.testing.assert_array_equal(static, dynamic)


def test_mxu_sampler_path_bit_identical():
    """The radix count-matmul sampling path (large W*n*batch) produces
    BIT-identical error vectors to the direct compare — exact 0/1 bf16
    products accumulated in f32, same jax.random stream (r5; the direct
    form was 4x the decode cost at the n=42010 probe codes)."""
    import jax.numpy as jnp

    from qec_ldpc.sampling import errors as E

    key = jax.random.PRNGKey(3)
    cases = [(610, 58, 64), (1000, 300, 32), (4201, 103, 8)]
    saved = E._ONESHOT_ELEMS
    try:
        for n, w, b in cases:
            xe1, ze1 = map(np.asarray, E.sample_weight_w_errors(key, n, w, b))
            E._ONESHOT_ELEMS = 0
            E.sample_weight_w_errors.clear_cache()
            xe2, ze2 = map(np.asarray, E.sample_weight_w_errors(key, n, w, b))
            assert np.array_equal(xe1, xe2) and np.array_equal(ze1, ze2), (n, w)
            # dynamic sampler through the count-matmul path honours the active mask
            E.sample_weight_w_errors_dynamic.clear_cache()
            xd, zd = map(np.asarray, E.sample_weight_w_errors_dynamic(
                key, n, jnp.int32(w), w, b))
            assert np.array_equal(xe1, xd) and np.array_equal(ze1, zd), (n, w)
            xs, zs = map(np.asarray, E.sample_weight_w_errors_dynamic(
                key, n, jnp.int32(w // 2), w, b))
            assert (xs | zs).sum() < (xe1 | ze1).sum()
            E._ONESHOT_ELEMS = saved
            E.sample_weight_w_errors.clear_cache()
            E.sample_weight_w_errors_dynamic.clear_cache()
    finally:
        E._ONESHOT_ELEMS = saved
        E.sample_weight_w_errors.clear_cache()
        E.sample_weight_w_errors_dynamic.clear_cache()
