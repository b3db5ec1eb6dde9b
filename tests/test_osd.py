"""OSD post-processing: native/NumPy parity, solver invariants, CSS splice,
and Monte-Carlo integration.

The reference has no analog (BP failures are merely counted,
``DecoderCPU.h:380-384,480-489``); these tests pin the framework-native
BP+OSD subsystem (decoder/osd.py, native/gf2.cpp::qec_osd_batch).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qec_ldpc as q
from qec_ldpc import native
from qec_ldpc.decoder import BPConfig, CSSPostprocessor, OSDecoder
from qec_ldpc.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    decode_batch,
)
from qec_ldpc.decoder.osd import _osd_one_np
from qec_ldpc.parallel.montecarlo import run_monte_carlo, run_monte_carlo_osd
from qec_ldpc.sampling import sample_weight_w_errors
from qec_ldpc.sampling.classify import (
    C_CORRECTED,
    C_CONV_X,
    C_CONV_Z,
    C_LOGICAL,
    C_SYN_X,
    C_SYN_Z,
    C_TESTED,
)


@pytest.fixture(scope="module")
def small_graphs():
    return CodeGraphs.build(q.construct_code(3, 3, 6, 7, 2, 3))


def _random_instance(rng, m, n, batch, p_col=0.25, p_err=0.1):
    H = (rng.random((m, n)) < p_col).astype(np.uint8)
    e_true = (rng.random((n, batch)) < p_err).astype(np.uint8)
    s = H @ e_true % 2
    rel = rng.standard_normal((n, batch)).astype(np.float32)
    return H, s, rel


@pytest.mark.parametrize("lam", [0, 8])
def test_osd_satisfies_syndrome_random(lam):
    rng = np.random.default_rng(3)
    for _ in range(20):
        m = int(rng.integers(5, 40))
        n = m + int(rng.integers(5, 40))
        H, s, rel = _random_instance(rng, m, n, batch=13)
        e, ok = OSDecoder(H, lam=lam).decode(s, rel)
        # syndromes from real errors are always in the column space
        assert ok.all()
        assert np.array_equal(H @ e % 2, s)


@pytest.mark.parametrize("lam", [0, 6])
def test_osd_native_matches_numpy(lam):
    if not native.native_available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    for _ in range(10):
        m = int(rng.integers(5, 30))
        n = m + int(rng.integers(5, 30))
        H, s, rel = _random_instance(rng, m, n, batch=7)
        e, ok = OSDecoder(H, lam=lam).decode(s, rel)
        order = np.argsort(rel, axis=0, kind="stable").T
        cols_bits = np.ascontiguousarray(H.T)
        for b in range(s.shape[1]):
            e_np, ok_np = _osd_one_np(cols_bits, s[:, b], order[b], lam)
            assert bool(ok[b]) == ok_np
            assert np.array_equal(e[:, b], e_np)


def test_osd_detects_unsolvable():
    rng = np.random.default_rng(5)
    H = np.zeros((4, 8), dtype=np.uint8)
    H[:3] = (rng.random((3, 8)) < 0.5).astype(np.uint8)
    s = np.zeros((4, 2), dtype=np.uint8)
    s[3, 1] = 1  # lane 1's syndrome hits the all-zero check row
    e, ok = OSDecoder(H, lam=2).decode(
        s, rng.standard_normal((8, 2)).astype(np.float32))
    assert ok[0] and not ok[1]
    assert not e[:, 1].any()


def test_combination_sweep_never_increases_weight():
    rng = np.random.default_rng(17)
    for _ in range(10):
        H, s, rel = _random_instance(rng, 20, 40, batch=5, p_col=0.3,
                                     p_err=0.15)
        e0, ok0 = OSDecoder(H, lam=0).decode(s, rel)
        e2, ok2 = OSDecoder(H, lam=10).decode(s, rel)
        assert ok0.all() and ok2.all()
        assert (e2.sum(axis=0) <= e0.sum(axis=0)).all()
        assert np.array_equal(H @ e2 % 2, s)


def test_osd_ranking_prefers_reliable_solution():
    # single-error syndrome with the true column marked most-unreliable:
    # OSD-0 must pick exactly that column
    rng = np.random.default_rng(23)
    n = 24
    H = (rng.random((16, n)) < 0.3).astype(np.uint8)
    e_true = np.zeros((n, 1), dtype=np.uint8)
    e_true[5] = 1
    s = H @ e_true % 2
    rel = np.full((n, 1), 10.0, dtype=np.float32)
    rel[5] = -10.0  # most likely in error
    e, ok = OSDecoder(H, lam=0).decode(s, rel)
    assert ok[0]
    assert np.array_equal(e, e_true)


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum",
                                       "layered-min-sum"])
def test_return_soft_shapes_and_ranking(small_graphs, algorithm):
    graphs = small_graphs
    n, batch = graphs.code.n, 16
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(2), n, 3, batch)
    sx = graphs.x.syndrome(xe.astype(jnp.int32))
    sz = graphs.z.syndrome(ze.astype(jnp.int32))
    cfg = BPConfig(max_iters=20, algorithm=algorithm,
                   return_soft=True)
    res = decode_batch(graphs, sx, sz, 0.02, cfg)
    assert res.soft_x.shape == (n, batch)
    assert res.soft_z.shape == (n, batch)
    if algorithm == "layered-min-sum":
        # layered soft IS the posterior: decisions == (posterior <= 0)
        assert np.array_equal(np.asarray(res.decisions_x),
                              np.asarray(res.soft_x <= 0.0).astype(np.int8))
    # soft defaults to None when not requested
    res2 = decode_batch(graphs, sx, sz, 0.02,
                        BPConfig(max_iters=20, algorithm=algorithm))
    assert res2.soft_x is None and res2.soft_z is None


def test_css_postprocessor_resolves_failures(small_graphs):
    graphs = small_graphs
    n, batch = graphs.code.n, 64
    # heavy errors so plenty of lanes fail BP
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(4), n, 5, batch)
    sx = graphs.x.syndrome(xe.astype(jnp.int32))
    sz = graphs.z.syndrome(ze.astype(jnp.int32))
    cfg = BPConfig(max_iters=15, return_soft=True)
    res = decode_batch(graphs, sx, sz, 0.02, cfg)
    ec0 = np.asarray(res.error_code)
    failed_x = (ec0 & SYNDROME_FAIL_X) != 0
    assert failed_x.any(), "fixture produced no BP failures; raise the weight"

    dx, dz, ec = CSSPostprocessor(graphs, lam=4).apply(
        np.asarray(sx), np.asarray(sz), res)
    # all syndrome failures resolved, and the fixes actually re-encode
    assert ((ec & (SYNDROME_FAIL_X | SYNDROME_FAIL_Z)) == 0).all()
    assert np.array_equal(
        np.asarray(graphs.x.syndrome(jnp.asarray(dx, jnp.int32))),
        np.asarray(sx))
    assert np.array_equal(
        np.asarray(graphs.z.syndrome(jnp.asarray(dz, jnp.int32))),
        np.asarray(sz))
    # untouched lanes keep their decisions; convergence flags preserved
    ok_lanes = (ec0 & (SYNDROME_FAIL_X | SYNDROME_FAIL_Z)) == 0
    assert np.array_equal(dx[:, ok_lanes],
                          np.asarray(res.decisions_x)[:, ok_lanes])
    syn_bits = SYNDROME_FAIL_X | SYNDROME_FAIL_Z
    assert np.array_equal(ec0 & ~syn_bits, ec & ~syn_bits)


@pytest.mark.parametrize("algorithm", ["sum-product", "layered-min-sum"])
def test_run_monte_carlo_osd_improves_on_base(small_graphs, algorithm):
    graphs = small_graphs
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    base, _ = run_monte_carlo(graphs, 4, 512, 0.02, cfg, seed=7,
                              batch_size=128)
    osd, _ = run_monte_carlo_osd(graphs, 4, 512, 0.02, cfg, seed=7,
                                 batch_size=128, lam=4)
    # same error draws (identical per-chunk keys)
    assert osd[C_TESTED] == base[C_TESTED]
    # every BP failure repaired into a syndrome-valid correction
    assert osd[C_SYN_X] == 0 and osd[C_SYN_Z] == 0
    assert osd[C_CORRECTED] + osd[C_LOGICAL] == osd[C_TESTED]
    assert osd[C_CORRECTED] >= base[C_CORRECTED]
    # convergence-fail counters keep their orthogonal reference meaning
    assert osd[C_CONV_X] == base[C_CONV_X]
    assert osd[C_CONV_Z] == base[C_CONV_Z]


def test_run_monte_carlo_osd_mesh_bitmatch(small_graphs):
    """VERDICT r2 #9: OSD composes with a device mesh.  The chunk key is
    partition-independent (one key per chunk; each shard_map shard slices
    its columns of the full-batch draw, and relay gammas slice the
    full-batch uniform), so mesh and single-device counters are
    BIT-IDENTICAL."""
    from qec_ldpc.parallel import make_mesh

    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    kw = dict(batch_size=64, lam=1, relay_retries=1)
    base, base_it = run_monte_carlo_osd(small_graphs, 4, 128, 0.02, cfg,
                                        seed=7, **kw)
    mesh = make_mesh(num_data=8)
    sharded, sh_it = run_monte_carlo_osd(small_graphs, 4, 128, 0.02, cfg,
                                         seed=7, mesh=mesh, **kw)
    np.testing.assert_array_equal(base, sharded)
    assert base_it == sh_it


def test_run_monte_carlo_osd_resume(small_graphs):
    """Chunk-exact resume: totals from (run chunk 0; resume at chunk 1) must
    equal the uninterrupted run."""
    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    kw = dict(batch_size=64, lam=0)
    full, _ = run_monte_carlo_osd(small_graphs, 4, 192, 0.02, cfg, seed=3,
                                  **kw)
    per_chunk = []
    run_monte_carlo_osd(small_graphs, 4, 192, 0.02, cfg, seed=3,
                        progress=lambda c, n, cnt, it: per_chunk.append(cnt),
                        **kw)
    resumed, _ = run_monte_carlo_osd(small_graphs, 4, 192, 0.02, cfg, seed=3,
                                     start_chunk=1,
                                     init_counters=per_chunk[0], **kw)
    np.testing.assert_array_equal(full, resumed)


def test_run_monte_carlo_osd_data_mesh_invariants(small_graphs):
    """The quality mode's shard_map device chunk on an 8-way data mesh:
    counters satisfy the OSD invariants (no syndrome failure survives
    OSD-0; every tested lane is corrected or a logical error)."""
    from qec_ldpc.parallel import make_mesh

    cfg = BPConfig(max_iters=10, algorithm="min-sum")
    osd, _ = run_monte_carlo_osd(small_graphs, 4, 64, 0.02, cfg, seed=5,
                                 batch_size=64, lam=0,
                                 mesh=make_mesh(num_data=8))
    assert osd[C_TESTED] == 64
    assert osd[C_SYN_X] == 0 and osd[C_SYN_Z] == 0
    assert osd[C_CORRECTED] + osd[C_LOGICAL] == osd[C_TESTED]


def test_gather_failed_lanes_prefix_only(small_graphs):
    """The fast quality mode must ship ONLY failed lanes to the host: the
    device chunk's nfail + compacted bundle agree with a full classification
    of the same chunk (counters_ok + failed-lane classification == the
    classify-everything counters)."""
    from qec_ldpc.parallel.montecarlo import (
        _gather_failed_lanes,
        _repair_and_classify_np,
        make_osd_chunk,
    )
    from qec_ldpc.sampling.classify import make_rank_basis_test

    graphs = small_graphs
    cfg = BPConfig(max_iters=10, algorithm="min-sum",
                   return_soft=True)
    lt = make_rank_basis_test(graphs.code)
    chunk = make_osd_chunk(graphs, 5, cfg, 128)
    counters_ok, iters, nfail, bundle = chunk(
        lt, jax.random.PRNGKey(3), jnp.float32(0.02))
    k = int(np.asarray(nfail)[0])
    assert k > 0, "fixture produced no failures; raise the weight"
    failed = _gather_failed_lanes(nfail, bundle)
    assert failed[-1].shape == (k,)          # exactly the failed lanes
    assert ((failed[-1] & (SYNDROME_FAIL_X | SYNDROME_FAIL_Z)) != 0).all()
    # counters_ok + classify(failed, no repair) == classify everything
    cnt_failed = _repair_and_classify_np(None, lt, failed)
    from qec_ldpc.parallel.montecarlo import _sample_and_decode
    from qec_ldpc.sampling.classify import classify_batch

    xe_i, ze_i, sx, sz, res = _sample_and_decode(
        graphs, jax.random.PRNGKey(3), 5, jnp.float32(0.02), cfg, 128,
        "weight")
    full = classify_batch(lt, xe_i, ze_i,
                          res.decisions_x.astype(jnp.int32),
                          res.decisions_z.astype(jnp.int32), res.error_code)
    np.testing.assert_array_equal(
        np.asarray(counters_ok, dtype=np.int64) + cnt_failed,
        np.asarray(full, dtype=np.int64))


def test_run_monte_carlo_osd_graph_mesh_bitmatch(small_graphs):
    """OSD with GRAPH-sharded decode (VERDICT r2 #9 completed): the
    (data x graph) mesh chunk samples from the same single key and the
    exact min-sum engine's decisions AND soft outputs bit-match the
    single-device path, so OSD counters are BIT-IDENTICAL."""
    from qec_ldpc.parallel import make_mesh

    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    kw = dict(batch_size=64, lam=1)
    base, base_it = run_monte_carlo_osd(small_graphs, 4, 128, 0.02, cfg,
                                        seed=7, **kw)
    mesh = make_mesh(num_data=4, num_graph=2)
    sharded, sh_it = run_monte_carlo_osd(small_graphs, 4, 128, 0.02, cfg,
                                         seed=7, mesh=mesh, **kw)
    np.testing.assert_array_equal(base, sharded)
    assert base_it == sh_it


def test_run_monte_carlo_osd_graph_mesh_with_relay(small_graphs):
    """Relay + OSD both graph-sharded: deterministic, fully repaired
    syndromes (OSD guarantees), tested count intact."""
    from qec_ldpc.parallel import make_mesh

    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    mesh = make_mesh(num_data=4, num_graph=2)
    kw = dict(batch_size=64, lam=0, relay_retries=2, mesh=mesh)
    a, _ = run_monte_carlo_osd(small_graphs, 4, 128, 0.02, cfg, seed=3, **kw)
    b, _ = run_monte_carlo_osd(small_graphs, 4, 128, 0.02, cfg, seed=3, **kw)
    np.testing.assert_array_equal(a, b)
    assert a[0] == 128
    assert a[4] == 0 and a[5] == 0  # OSD leaves no syndrome failures


# ---- OSD-0 on the QC codes ----

def test_osd0_native_matches_numpy_on_qc_codes():
    """The native batched OSD-0 solver matches the NumPy reference bit for
    bit on the real QC parity-check matrices — corrections AND solved
    flags, decodable and undecodable syndromes."""
    if not native.native_available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(7)
    for params, lanes in (((3, 3, 6, 7, 2, 3), 21), ((4, 5, 10, 61, 9, 49), 3)):
        code = q.construct_code(*params)
        for h in (code.pcm_x % 2, code.pcm_z % 2):
            m, n = h.shape
            e_true = (rng.random((n, lanes)) < 0.08).astype(np.int32)
            syn = (np.asarray(h, int) @ e_true) % 2
            syn[:, -1] = rng.integers(0, 2, m)  # mostly undecodable
            rel = rng.standard_normal((n, lanes)).astype(np.float32)
            e, ok = OSDecoder(h, lam=0).decode(syn, rel)
            order = np.argsort(rel, axis=0, kind="stable").T
            cols_bits = np.ascontiguousarray(np.asarray(h, np.uint8).T)
            for b in range(lanes):
                e_np, ok_np = _osd_one_np(cols_bits, syn[:, b], order[b], 0)
                assert bool(ok[b]) == ok_np
                assert np.array_equal(e[:, b], e_np)
            sat = (np.asarray(h, int) @ e.astype(int)) % 2 == syn
            assert np.all(sat[:, ok])


def test_quality_mode_matches_offline_postprocess(small_graphs):
    """run_monte_carlo_osd's fast path (device classify of clean lanes,
    compacted failed-lane fetch, host OSD-0) gives exactly the counters of
    the plain composition: decode every chunk, OSD-repair the whole batch
    on the host, classify everything."""
    from qec_ldpc.parallel.montecarlo import (
        _repair_and_classify_np,
        _sample_and_decode,
    )
    from qec_ldpc.sampling.classify import make_rank_basis_test

    graphs = small_graphs
    cfg = BPConfig(max_iters=30, algorithm="min-sum", return_soft=True)
    counters, _ = run_monte_carlo_osd(graphs, 4, 512, 0.02, cfg, seed=9,
                                      batch_size=256, lam=0)
    lt = make_rank_basis_test(graphs.code)
    post = CSSPostprocessor(graphs, lam=0)
    want = np.zeros_like(counters)
    for c in range(2):
        ck = jax.random.fold_in(jax.random.PRNGKey(9), np.uint32(c))
        xe, ze, sx, sz, res = _sample_and_decode(
            graphs, ck, 4, jnp.float32(0.02), cfg, 256, "weight")
        bundle = tuple(np.asarray(a) for a in (
            xe, ze, sx, sz, res.decisions_x, res.decisions_z, res.soft_x,
            res.soft_z, res.error_code))
        want += _repair_and_classify_np(post, lt, bundle)
    np.testing.assert_array_equal(counters, want)
    assert counters[C_SYN_X] == 0 and counters[C_SYN_Z] == 0
