"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases runs at a tiny size with two CPU devices standing in for the
accelerator and its CPU reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from qec_ldpc.codes import construct_code
from qec_ldpc.decoder import BPConfig, CodeGraphs, decode_batch
from qec_ldpc.decoder.decode import syndromes_from_errors
from qec_ldpc.sampling import sample_weight_w_errors


@pytest.fixture(scope="module")
def qc7():
    return CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))


@pytest.fixture(scope="module")
def two_devices():
    devs = jax.devices()
    return devs[0], devs[1]


def test_refuses_cpu_platform(capsys, tmp_path):
    assert chip_smoke.main(["--out", str(tmp_path)]) != 0
    out = capsys.readouterr()
    assert "no GPU" in out.err
    assert '"ok"' not in out.out


@pytest.mark.parametrize("algorithm", chip_smoke.ALGORITHMS)
def test_compare_engines(qc7, two_devices, algorithm):
    cfg = BPConfig(max_iters=30, algorithm=algorithm)
    s = chip_smoke.compare_engines(qc7, cfg, two_devices, 32, weight=3)
    assert s["differing_lanes"] == 0
    assert s["counters"] == s["reference_counters"]
    assert s["counters"][0] == 32


def test_counters_agree_band():
    a = np.array([1000, 1000, 1000, 990, 5, 5, 0, 0, 0])
    assert chip_smoke.counters_agree(a, a, 1000)
    b = a.copy()
    b[3] = 900
    assert not chip_smoke.counters_agree(a, b, 1000)


@pytest.mark.parametrize("algorithm", chip_smoke.ALGORITHMS)
def test_per_lane_iterations_match_single_lane_decodes(qc7, algorithm):
    """The useful-work measure: each lane's vmapped trip count equals the
    X + Z iterations of decoding that lane alone."""
    cfg = BPConfig(max_iters=30, algorithm=algorithm)
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(4), qc7.code.n, 3, 6)
    sx, sz = syndromes_from_errors(qc7, xe.astype(jnp.int32),
                                   ze.astype(jnp.int32))
    n = np.asarray(chip_smoke.per_lane_iterations(qc7, sx, sz,
                                                  jnp.float32(0.02), cfg))
    for b in range(6):
        res = decode_batch(qc7, sx[:, b:b + 1], sz[:, b:b + 1], 0.02, cfg)
        assert n[b] == int(res.iters_x) + int(res.iters_z)


def test_headline_run(qc7):
    cfg = BPConfig(max_iters=30)
    r = chip_smoke.headline_run(qc7, cfg, 2, 0.02, 96, 32, repeats=1,
                                useful_batch=32)
    assert r["samples"] == 96
    assert r["samples_per_s"] > 0 and r["compile_s"] >= 0
    assert 0 < r["useful_per_sample"] <= r["executed_per_sample"]
    assert 0 < r["useful_share"] <= 1


def test_phase_cli_writes_reference_record(tmp_path):
    r = chip_smoke.phase_cli(str(tmp_path), code_spec="qc:3,3,6,7,2,3",
                             count=1024, weight=1)
    assert r["samples"] >= 1024 and r["parity"]
    with open(r["results_file"]) as f:
        assert f.read().startswith("Code: [J=3,K=3,L=6,P=7,s=2,t=3]")


def test_phase_cli_parity_gate_fails_loudly(tmp_path):
    with pytest.raises(chip_smoke.PhaseFailed, match="parity"):
        chip_smoke.phase_cli(str(tmp_path), code_spec="qc:3,3,6,7,2,3",
                             count=1024, weight=4)


def test_phase_bicycle_tiny(two_devices):
    r = chip_smoke.phase_bicycle(two_devices, count=64, batch=32,
                                 agree_batch=16)
    assert r["samples"] == 64 and r["agree"]["differing_lanes"] == 0


def test_phase_large_p_tiny(two_devices):
    r = chip_smoke.phase_large_p(two_devices, P=131, weight=4, count=32,
                                 batch=16, agree_batch=8)
    assert "P=131" in r["code"] and r["samples"] == 32


def test_phase_quality_tiny(qc7):
    r = chip_smoke.phase_quality(qc7, weight=4, chunks=2, batch=64)
    assert r["samples"] == 128 and 0 < r["corrected_fraction"] <= 1


def test_phase_four_card_on_cpu_mesh(qc7):
    """The four-card path on four virtual CPU devices: data-parallel
    headline and the data x graph bit-match (L=6, graph axis 2)."""
    r = chip_smoke.phase_four_card(
        qc7, jax.devices()[:4], count=256, batch=128, graph_count=128,
        graph_batch=32, weight=1)
    runs = r["graph_sharded"]
    assert runs["data2_graph2"]["counters"] == runs["data2_graph1"]["counters"]


def test_cpu_reference_stays_out_of_compile_cache():
    key = "jax_persistent_cache_min_compile_time_secs"
    before = getattr(jax.config, key)
    with chip_smoke.outside_compile_cache(jax.devices("cpu")[0]):
        assert getattr(jax.config, key) == float("inf")
    assert getattr(jax.config, key) == before
