"""Graph-parallel Monte-Carlo statistics (parallel/mc_graph.py).

The VERDICT-r2 integration gap: the graph-sharded decoders must be drivable
by the statistics harness (``DecoderCPU.h:392-530`` + ``main.cu:91-104``
running on the sharded engine).  Pins:

* (data x graph) chunk counters BIT-MATCH the data-only chunk for the exact
  decoders (min-sum, layered-min-sum) on circulant AND lifted codes — same
  samples (identical key derivation), association-free cross-shard
  reductions;
* sum-product matches statistically (cross-device products reassociate);
* ``run_monte_carlo`` dispatches on the mesh's graph axis;
* the CLI runs end-to-end with ``num_graph=2`` and writes a correct
  reference-format results file;
* unsupported configurations fail loudly (non-dividing
  graph-axis sizes); relay and OSD compose (tested here and in test_osd).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qec_ldpc.codes import construct_code, known_bicycle_code, toric_code
from qec_ldpc.decoder import BPConfig, CodeGraphs
from qec_ldpc.parallel import (
    make_graph_sharded_chunk,
    make_mesh,
    make_sharded_chunk,
    run_monte_carlo,
)
from qec_ldpc.sampling.classify import make_rank_basis_test

KEY = jax.random.PRNGKey(3)
IDS = jnp.arange(2, dtype=jnp.uint32)


def _counters(graphs, test, cfg, num_graph, weight=2, p=0.02,
              error_model="weight", num_data=4, batch_per_device=8):
    devs = jax.devices()
    mesh = make_mesh(num_data=num_data, num_graph=num_graph,
                     devices=devs[: num_data * num_graph])
    if num_graph > 1:
        fn = make_graph_sharded_chunk(mesh, graphs, weight=weight, cfg=cfg,
                                      batch_per_device=batch_per_device,
                                      error_model=error_model)
    else:
        fn = make_sharded_chunk(mesh, graphs, weight=weight, cfg=cfg,
                                batch_per_device=batch_per_device,
                                error_model=error_model)
    c, i = fn(test, KEY, jnp.float32(p), IDS)
    return np.asarray(c), np.asarray(i)


@pytest.fixture(scope="module")
def qc7():
    code = construct_code(3, 3, 6, 7, 2, 3)
    return code, CodeGraphs.build(code), make_rank_basis_test(code)


@pytest.mark.parametrize("algorithm", ["min-sum", "layered-min-sum"])
def test_circulant_exact_bitmatch(qc7, algorithm):
    _, graphs, test = qc7
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    cd, idd = _counters(graphs, test, cfg, num_graph=1)
    cg, ig = _counters(graphs, test, cfg, num_graph=2)
    np.testing.assert_array_equal(cd, cg)
    np.testing.assert_array_equal(idd, ig)
    assert cd[0] == 2 * 4 * 8  # chunks * data shards * batch_per_device


def test_circulant_sum_product_statistical(qc7):
    _, graphs, test = qc7
    cfg = BPConfig(max_iters=20)
    cd, _ = _counters(graphs, test, cfg, num_graph=1)
    cg, _ = _counters(graphs, test, cfg, num_graph=2)
    assert cd[0] == cg[0]
    # corrected fractions agree within a loose statistical band
    assert abs(int(cd[3]) - int(cg[3])) <= max(4, 0.1 * cd[0])


@pytest.mark.parametrize("make_code", [lambda: toric_code(4),
                                       lambda: known_bicycle_code("[[72,12,6]]")],
                         ids=["toric4", "bb72"])
def test_lifted_min_sum_bitmatch(make_code):
    code = make_code()
    graphs = code.build_graphs()
    test = make_rank_basis_test(code)
    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    cd, idd = _counters(graphs, test, cfg, num_graph=1, weight=1, p=0.01)
    cg, ig = _counters(graphs, test, cfg, num_graph=2, weight=1, p=0.01)
    np.testing.assert_array_equal(cd, cg)
    np.testing.assert_array_equal(idd, ig)


def test_run_monte_carlo_dispatches_on_graph_axis(qc7):
    _, graphs, test = qc7
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    devs = jax.devices()
    kw = dict(weight=2, count=128, error_probability=0.02, cfg=cfg, seed=9,
              batch_size=32, i_minus_p=test)
    cd, itd = run_monte_carlo(
        graphs, mesh=make_mesh(num_data=4, num_graph=1, devices=devs[:4]),
        **kw)
    cg, itg = run_monte_carlo(
        graphs, mesh=make_mesh(num_data=4, num_graph=2, devices=devs), **kw)
    np.testing.assert_array_equal(cd, cg)
    assert itd == itg


def test_unsupported_configs_fail_loudly(qc7):
    _, graphs, test = qc7
    with pytest.raises(ValueError, match="divide"):
        make_graph_sharded_chunk(
            make_mesh(num_data=1, num_graph=4, devices=jax.devices()[:4]),
            graphs, weight=2, cfg=BPConfig(max_iters=10), batch_per_device=8)


def test_cli_num_graph_end_to_end(tmp_path, small_code_file):
    """`python -m qec_ldpc.harness.cli init.txt` with num_graph=2
    produces a correct reference-format results file (VERDICT r2 #1 done
    criterion), with counters bit-matching the data-only run (min-sum)."""
    from qec_ldpc.harness.cli import run_sweep
    from qec_ldpc.harness.config import load_init_file

    common = (f"{small_code_file} 2 2 64 20 0.02 seed=5 batch_size=32 "
              f"algorithm=min-sum log_file={tmp_path}/log.txt ")
    init = tmp_path / "init.txt"
    init.write_text(common + f"results_dir={tmp_path}/r_data\n")
    base = run_sweep(load_init_file(str(init)))[0]
    init.write_text(common + f"results_dir={tmp_path}/r_graph num_graph=2\n")
    graph = run_sweep(load_init_file(str(init)))[0]
    assert graph.num_errors_tested == base.num_errors_tested == 64
    # the data-only CLI mesh puts all 8 devices on the data axis while the
    # 4x2 mesh has 4 -> different sample partition, so agreement here is
    # statistical (the bit-match at equal num_data is pinned in
    # test_run_monte_carlo_dispatches_on_graph_axis)
    assert abs(graph.corrected - base.corrected) <= 8
    assert graph.corrected + graph.logical_errors <= graph.num_errors_tested
    out = list((tmp_path / "r_graph").glob("*_W_2_MAX_20_p_0.02.txt"))
    assert len(out) == 1


def test_relay_on_graph_mesh(qc7):
    """Graph-sharded relay (circulant): deterministic, repairs only ever
    reduce syndrome failures and raise corrected counts, and the tested
    population is unchanged.  Repairs agree with the data-parallel relay
    statistically (different damping streams), so no bit-match claim."""
    _, graphs, test = qc7
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    base, base_it = _counters(graphs, test, cfg, num_graph=2, weight=4)
    relayed, relay_it = _counters_relay(graphs, test, cfg, weight=4)
    relayed2, _ = _counters_relay(graphs, test, cfg, weight=4)
    np.testing.assert_array_equal(relayed, relayed2)
    assert relayed[0] == base[0]
    assert relayed[4] <= base[4] and relayed[5] <= base[5]  # syn fails drop
    assert relayed[3] + relayed[6] >= base[3] + base[6]     # repaired lanes
    assert base[4] + base[5] > 0, "weight-4 must produce failures to repair"
    assert relayed[4] + relayed[5] < base[4] + base[5], "relay repaired none"
    assert relay_it.sum() > base_it.sum()  # retry work is accounted


def _counters_relay(graphs, test, cfg, weight, p=0.02, error_model="weight",
                    retries=4):
    devs = jax.devices()
    mesh = make_mesh(num_data=4, num_graph=2, devices=devs)
    fn = make_graph_sharded_chunk(mesh, graphs, weight=weight, cfg=cfg,
                                  batch_per_device=8, relay_retries=retries,
                                  error_model=error_model)
    c, i = fn(test, KEY, jnp.float32(p), IDS)
    return np.asarray(c), np.asarray(i)


def test_relay_on_lifted_graph_mesh():
    """Lane-sharded relay (BB [[72,12,6]]): syndrome failures strictly drop,
    tested population unchanged, deterministic.  (The toric code is the
    wrong testbed: its degenerate trapping sets resist damping disorder —
    data-parallel relay repairs nothing there either; BP+OSD is the toric
    quality mode, docs/DECODERS.md.)"""
    code = known_bicycle_code("[[72,12,6]]")
    graphs = code.build_graphs()
    test = make_rank_basis_test(code)
    cfg = BPConfig(max_iters=30, algorithm="min-sum")
    base, _ = _counters(graphs, test, cfg, num_graph=2, weight=0, p=0.05,
                        error_model="depolarizing")
    relayed, _ = _counters_relay(graphs, test, cfg, weight=0, p=0.05,
                                 error_model="depolarizing", retries=8)
    relayed2, _ = _counters_relay(graphs, test, cfg, weight=0, p=0.05,
                                  error_model="depolarizing", retries=8)
    np.testing.assert_array_equal(relayed, relayed2)
    assert relayed[0] == base[0]
    assert base[4] + base[5] > 0, "p=0.05 must produce failures to repair"
    assert relayed[4] + relayed[5] < base[4] + base[5], "relay repaired none"
    assert relayed[3] + relayed[6] >= base[3] + base[6]


def test_depolarizing_model_bitmatch(qc7):
    _, graphs, test = qc7
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    cd, _ = _counters(graphs, test, cfg, num_graph=1, weight=0, p=0.03,
                      error_model="depolarizing")
    cg, _ = _counters(graphs, test, cfg, num_graph=2, weight=0, p=0.03,
                      error_model="depolarizing")
    np.testing.assert_array_equal(cd, cg)


def test_cli_osd_with_num_graph(tmp_path, small_code_file):
    """osd= now composes with num_graph= in the CLI (graph-sharded decode,
    soft outputs gathered for the host OSD splice)."""
    from qec_ldpc.harness.cli import run_sweep
    from qec_ldpc.harness.config import load_init_file

    init = tmp_path / "init.txt"
    init.write_text(f"{small_code_file} 4 4 64 15 0.02 seed=5 batch_size=32 "
                    f"algorithm=min-sum num_graph=2 osd=0 "
                    f"results_dir={tmp_path}/r log_file={tmp_path}/log.txt\n")
    stats = run_sweep(load_init_file(str(init)))[0]
    assert stats.num_errors_tested == 64
    assert stats.syndrome_errors_x == 0 and stats.syndrome_errors_z == 0
    assert stats.corrected + stats.logical_errors == 64
