"""Harness tests: init parsing, result naming/format parity, journal resume."""

import os

import numpy as np
import pytest

from qec_ldpc.harness import (
    CodeStatistics,
    Journal,
    RunConfig,
    format_result_filename,
    load_init_file,
    parse_reference_text,
)

#: the reference's headline results record (results/[J=4,K=5,L=10,P=61,s=9,
#: t=49][[n=610,k=61]]_W_15_MAX_100_p_0.01.txt), pinned verbatim
REF_RECORD = """Code: [J=4,K=5,L=10,P=61,s=9,t=49][[n=610,k=61]]
Rand Seed: 2287037912
Duration(micro-s): 112731735
Errors Tested: 100000
Errors With X: 100000
Errors With Z: 100000
Error Weight: 15
Corrected: 99539
Syndrome Errors X: 209
Syndrome Errors Z: 251
Logical Errors: 1
Convergence Fail X: 0
Convergence Fail Z: 0
"""


@pytest.fixture
def ref_init(tmp_path):
    """The reference's literal init.txt, beside a code610.txt of its own
    name (only its location matters to the parser)."""
    (tmp_path / "code610.txt").write_text("")
    init = tmp_path / "init.txt"
    init.write_text("code610.txt\n15\n15\n100000\n100\n0.01\n")
    return str(init)


def test_load_reference_init_file(ref_init):
    cfg = load_init_file(ref_init)
    # the relative codeFile resolves against the init file's own directory
    # (the reference runs with cwd = its exe dir, main.cu:74-78)
    assert cfg.code_file == os.path.join(os.path.dirname(ref_init),
                                         "code610.txt")
    assert cfg.weight_start == 15 and cfg.weight_end == 15
    assert cfg.count == 100000
    assert cfg.max_iterations == 100
    assert cfg.error_probability == pytest.approx(0.01)


def test_init_file_extensions(tmp_path):
    p = tmp_path / "init.txt"
    p.write_text("code.txt 1 3 1000 50 0.02 seed=7 batch_size=256 algorithm=min-sum\n")
    cfg = load_init_file(str(p))
    assert cfg.seed == 7 and cfg.batch_size == 256 and cfg.algorithm == "min-sum"


def test_init_file_rejects_unknown_key(tmp_path):
    p = tmp_path / "init.txt"
    p.write_text("code.txt 1 3 1000 50 0.02 bogus=1\n")
    with pytest.raises(ValueError):
        load_init_file(str(p))


def test_result_filename_matches_golden_corpus(code610):
    # the actual filename shipped in the reference results directory
    name = format_result_filename(str(code610), 15, 100, 0.01)
    assert name == "[J=4,K=5,L=10,P=61,s=9,t=49][[n=610,k=61]]_W_15_MAX_100_p_0.01.txt"


def test_stats_text_format_matches_reference(code610):
    """Our serialization must produce the same keys in the same order as the
    reference operator<< (checked against the pinned golden record)."""
    counters = np.array([100000, 100000, 100000, 99539, 209, 251, 1, 0, 0])
    stats = CodeStatistics.from_counters(code610, 2287037912, 15, counters, 112731735)
    ours = parse_reference_text(stats.to_reference_text())[0]
    golden = parse_reference_text(REF_RECORD)[0]
    assert list(ours.keys()) == list(golden.keys())
    assert ours == golden  # byte-identical field values for the golden numbers


def test_journal_resume(tmp_path):
    j = Journal(str(tmp_path / "journal.jsonl"))
    for c in range(3):
        j.append({"run_id": "r1", "weight": 5, "chunk": c,
                  "counters": [10, 1, 2, 3, 4, 5, 6, 7, 8], "iters": 100})
    j.append({"run_id": "r1", "weight": 6, "chunk": 0,
              "counters": [10, 0, 0, 0, 0, 0, 0, 0, 0], "iters": 50})
    j.close()
    j2 = Journal(str(tmp_path / "journal.jsonl"))
    next_chunk, counters, iters = j2.resume_state("r1", 5)
    assert next_chunk == 3
    assert counters[0] == 30 and iters == 300
    next_chunk, counters, iters = j2.resume_state("r1", 6)
    assert next_chunk == 1
    next_chunk, counters, iters = j2.resume_state("r2", 5)
    assert next_chunk == 0 and counters is None


def test_journal_tolerates_torn_line(tmp_path):
    path = tmp_path / "journal.jsonl"
    j = Journal(str(path))
    j.append({"run_id": "r", "weight": 1, "chunk": 0,
              "counters": [1] * 9, "iters": 1})
    j.close()
    with open(path, "a") as f:
        f.write('{"run_id": "r", "weight": 1, "chu')  # crash mid-write
    j2 = Journal(str(path))
    next_chunk, counters, iters = j2.resume_state("r", 1)
    assert next_chunk == 1


def test_sweep_points_weight_and_p_modes():
    cfg = RunConfig("c.txt", 2, 4, 100, 50, 0.01)
    assert cfg.sweep_points() == [(2, 0.01), (3, 0.01), (4, 0.01)]
    cfg.p_values = "0.001, 0.01 0.02"
    assert cfg.sweep_points() == [(2, 0.001), (2, 0.01), (2, 0.02)]


def test_debug_write_array_reference_format(tmp_path):
    from qec_ldpc.harness import debug

    p = str(tmp_path / "dump.txt")
    debug.write_array(p, np.array([[1, 0], [0, 1]]))
    debug.write_array(p, np.array([0.5, 0.25]))  # appends (ArrayOutput.h:9)
    assert open(p).read() == "1 0\n0 1\n\n0.5 0.25\n\n"


def test_run_sweep_end_to_end(tmp_path, small_code_file):
    """Full CLI path on the CPU mesh: init file -> sweep -> results files with
    reference-format records -> journal resume is a no-op re-run."""
    from qec_ldpc.harness.cli import run_sweep

    init = tmp_path / "init.txt"
    init.write_text(
        f"{small_code_file} 1 2 64 20 0.02 seed=5 batch_size=32 "
        f"results_dir={tmp_path}/results log_file={tmp_path}/log.txt\n")
    cfg = load_init_file(str(init))
    stats = run_sweep(cfg)
    assert len(stats) == 2
    assert stats[0].num_errors_tested == 64
    assert stats[0].error_weight == 1
    out = os.listdir(f"{tmp_path}/results")
    assert any("_W_1_MAX_20_p_0.02.txt" in f for f in out)
    rec = parse_reference_text(
        open(os.path.join(f"{tmp_path}/results",
                          [f for f in out if "_W_1_" in f][0])).read())[0]
    assert rec["Errors Tested"] == "64"
    # resume: all chunks journaled -> instant, identical counters
    stats2 = run_sweep(cfg)
    assert stats2[0].corrected == stats[0].corrected
    assert stats2[1].corrected == stats[1].corrected


def test_run_sweep_osd_mode(tmp_path, small_code_file):
    """osd=<lam> init extension routes through the OSD quality path: same
    samples, zero syndrome failures, corrected count never drops."""
    from qec_ldpc.harness.cli import run_sweep

    common = (f"{small_code_file} 4 4 64 15 0.02 seed=5 batch_size=32 "
              f"log_file={tmp_path}/log.txt use_mesh=false ")
    init = tmp_path / "init.txt"
    init.write_text(common + f"results_dir={tmp_path}/r_base\n")
    base = run_sweep(load_init_file(str(init)))[0]
    init.write_text(common + f"results_dir={tmp_path}/r_osd osd=4\n")
    osd = run_sweep(load_init_file(str(init)))[0]
    assert osd.num_errors_tested == base.num_errors_tested
    assert osd.syndrome_errors_x == 0 and osd.syndrome_errors_z == 0
    assert osd.corrected >= base.corrected
    assert osd.corrected + osd.logical_errors == osd.num_errors_tested


def test_malformed_code_specs_raise_helpful_errors():
    """ADVICE r2: hgp:/toric:/bb:/qc: spec typos name the expected format."""
    from qec_ldpc.harness.cli import load_code_and_graphs

    for spec in ["toric:abc", "hgp:n1=3,h1=1+x", "bb:l=12,m=6,A=x3",
                 "qc:3,3,6", "hgp:n1=x,n2=7,h1=1,h2=1"]:
        with pytest.raises(ValueError, match="malformed code spec"):
            load_code_and_graphs(spec)


def test_run_sweep_osd_journal_resume_and_mesh(tmp_path, small_code_file):
    """VERDICT r2 #9 done criterion: osd>=0 no longer disables mesh/resume.
    The OSD run journals post-repair counters; a rerun resumes to identical
    stats without recomputation, and the mesh stays enabled."""
    from qec_ldpc.harness.cli import run_sweep
    from qec_ldpc.harness.config import load_init_file

    init = tmp_path / "init.txt"
    init.write_text(
        f"{small_code_file} 4 4 64 15 0.02 seed=5 batch_size=32 osd=0 "
        f"algorithm=min-sum results_dir={tmp_path}/results "
        f"log_file={tmp_path}/log.txt\n")
    cfg = load_init_file(str(init))
    first = run_sweep(cfg)[0]
    assert os.path.exists(f"{tmp_path}/results/journal.jsonl")
    journal_len = len(open(f"{tmp_path}/results/journal.jsonl").readlines())
    assert journal_len >= 2  # one record per OSD chunk (64/32)
    second = run_sweep(cfg)[0]
    assert second.corrected == first.corrected
    assert second.logical_errors == first.logical_errors
    # resume appended no new chunk records
    assert len(open(f"{tmp_path}/results/journal.jsonl").readlines()) == journal_len
    # log records the resume
    assert "resuming" in open(f"{tmp_path}/log.txt").read()


def test_cli_flag_form(tmp_path):
    """The documented --code flag form of the CLI (no init file needed)."""
    from qec_ldpc.harness.cli import main

    rc = main(["--code", "qc:3,3,6,7,2,3", "--w", "2", "--count", "64",
               "--max", "20", "--p", "0.02", "--seed", "5",
               "--batch_size", "32", "--algorithm", "min-sum",
               f"--results_dir={tmp_path}/results",
               f"--log_file={tmp_path}/log.txt"])
    assert rc == 0
    out = list((tmp_path / "results").glob("*_W_2_MAX_20_p_0.02.txt"))
    assert len(out) == 1
    rec = parse_reference_text(open(out[0]).read())[0]
    assert rec["Errors Tested"] == "64"


def test_cli_flag_form_errors():
    from qec_ldpc.harness.cli import _config_from_flags

    with pytest.raises(ValueError, match="--code"):
        _config_from_flags(["--w", "3"])
    with pytest.raises(ValueError, match="unknown option"):
        _config_from_flags(["--code", "x", "--bogus", "1"])
    with pytest.raises(ValueError, match="needs a value"):
        _config_from_flags(["--code"])


def test_cli_logs_errors_to_run_log(tmp_path):
    """Failures append to the run log before exiting (main.cu:106-112)."""
    from qec_ldpc.harness.cli import main

    with pytest.raises(ValueError):
        main(["--code", "qc:3,3,6", "--count", "32",
              f"--results_dir={tmp_path}/r", f"--log_file={tmp_path}/log.txt"])
    assert "ERROR:" in open(f"{tmp_path}/log.txt").read()


def test_cli_flag_form_rejects_inverted_weight_range():
    from qec_ldpc.harness.cli import _config_from_flags

    with pytest.raises(ValueError, match="below"):
        _config_from_flags(["--code", "x", "--w", "5", "--W", "2"])


def test_bool_options_are_strict(tmp_path):
    """Advisor finding r3: a typo'd boolean must raise, not silently become
    False."""
    from qec_ldpc.harness.cli import _config_from_flags

    with pytest.raises(ValueError, match="use_mesh"):
        _config_from_flags(["--code", "qc:3,3,6,7,2,3", "--use_mesh", "ture"])
    p = tmp_path / "init.txt"
    p.write_text("code.txt 1 1 10 5 0.01 use_mesh=on\n")
    assert load_init_file(str(p)).use_mesh is True
    p.write_text("code.txt 1 1 10 5 0.01 use_mesh=nope\n")
    with pytest.raises(ValueError, match="use_mesh"):
        load_init_file(str(p))


def test_init_file_flag_overrides(ref_init):
    """The literal reference init file + repo-local output overrides
    (VERDICT r3 #7 plumbing): trailing flags layer on top of the file."""
    from qec_ldpc.harness.cli import _apply_flag_values, _parse_flag_tokens

    cfg = load_init_file(ref_init)
    ov = _parse_flag_tokens(["--results_dir", "/tmp/x", "--count=5"])
    _apply_flag_values(cfg, ov)
    assert cfg.results_dir == "/tmp/x"
    assert cfg.count == 5
    assert cfg.code_file == os.path.join(os.path.dirname(ref_init),
                                         "code610.txt")


def test_cli_logical_test_honors_divergent_shipped_iminusp(small_code_file):
    """Advisor r3: a file-shipped iMinusP with a DIFFERENT kernel than the
    PCM-derived annihilator must win over the rank-basis rebuild (with a
    note); the reference's own file, whose matrix IS the annihilator,
    resolves to the rank-basis test silently."""
    import dataclasses

    import numpy as np

    from qec_ldpc.codes import construct_code, load_code_file
    from qec_ldpc.harness.cli import resolve_logical_test_for_code
    from qec_ldpc.sampling.classify import RankBasisTest

    ref = load_code_file(small_code_file)
    test, note = resolve_logical_test_for_code(ref, "reference")
    assert isinstance(test, RankBasisTest) and note is None

    # same code, deliberately different iMinusP (identity: kernel = {0})
    n2 = 2 * ref.n
    weird = dataclasses.replace(ref, _i_minus_p=np.eye(n2, dtype=np.int64))
    test2, note2 = resolve_logical_test_for_code(weird, "reference")
    assert note2 is not None and "FILE" in note2
    assert not isinstance(test2, RankBasisTest)
    assert np.array_equal(np.asarray(test2), np.eye(n2))

    # constructed codes have no shipped matrix: always the rank basis
    qc = construct_code(3, 3, 6, 7, 2, 3)
    test3, note3 = resolve_logical_test_for_code(qc, "reference")
    assert isinstance(test3, RankBasisTest) and note3 is None


def test_cli_sweep_uses_dynamic_weight(tmp_path):
    """Multi-weight CLI sweeps ride the dynamic sampler (one compiled
    program per sweep, r4): the run completes, every weight gets its
    result record, and the journal run_id pins the sampler mode (wcap) so
    resumes never blend streams."""
    import json

    from qec_ldpc.harness.cli import run_sweep

    rd = str(tmp_path / "res")
    cfg = RunConfig(
        code_file="qc:3,3,6,7,2,3", weight_start=1, weight_end=3,
        count=128, max_iterations=10, error_probability=0.02, seed=4,
        batch_size=64, algorithm="min-sum", use_mesh=False,
        results_dir=rd, log_file=os.path.join(rd, "log.txt"))
    stats = run_sweep(cfg)
    assert [s.error_weight for s in stats] == [1, 2, 3]
    assert all(s.num_errors_tested == 128 for s in stats)
    # heavier weights correct fewer samples (sanity of the traced weight)
    assert stats[0].corrected >= stats[1].corrected >= stats[2].corrected
    journal = [json.loads(ln) for ln in
               open(os.path.join(rd, "journal.jsonl"))]
    assert all("wcap=8" in rec["run_id"] for rec in journal)

    # single-point runs keep the static sampler (artifact reproducibility)
    cfg2 = RunConfig(
        code_file="qc:3,3,6,7,2,3", weight_start=2, weight_end=2,
        count=128, max_iterations=10, error_probability=0.02, seed=4,
        batch_size=64, algorithm="min-sum", use_mesh=False,
        results_dir=rd, log_file=os.path.join(rd, "log.txt"))
    run_sweep(cfg2)
    journal = [json.loads(ln) for ln in
               open(os.path.join(rd, "journal.jsonl"))]
    assert any("wcap" not in rec["run_id"] for rec in journal)


def test_parse_old_format_reference_text():
    """The 2017 dated-directory serialization parses: split Logical Errors
    X/Z lines get a derived unified counter, and the old 'code:'-prefixed
    Code string yields its parameters (VERDICT r4 #5)."""
    from qec_ldpc.harness import parse_code_params, parse_reference_text

    old = (
        "Code: code: J=2,K=3,L=6,P=7,sigma=2,tau=3 [[n=42,k=7]]\n"
        "Rand Seed: 1455072744\n"
        "Duration(micro-s): 653589941\n"
        "Errors Tested: 100000\n"
        "Error Weight: 20\n"
        "Corrected: 1438\n"
        "Syndrome Errors X: 96605\n"
        "Syndrome Errors Z: 56718\n"
        "Logical Errors X: 0\n"
        "Logical Errors Z: 3\n"
        "Convergence Fail X: 96605\n"
        "Convergence Fail Z: 55327\n")
    recs = parse_reference_text(old)
    assert len(recs) == 1
    rec = recs[0]
    assert rec["Logical Errors"] == "3"  # derived X+Z sum
    assert "Errors With X" not in rec    # old-format marker
    assert parse_code_params(rec["Code"]) == (2, 3, 6, 7, 2, 3)
    # final-format string parses identically
    assert parse_code_params(
        "[J=3,K=3,L=6,P=7,s=2,t=3][[n=42,k=0]]") == (3, 3, 6, 7, 2, 3)
    # a derived entry never overrides a real unified counter
    both = old.replace("Logical Errors X: 0\n", "Logical Errors: 7\n"
                       "Logical Errors X: 0\n")
    assert parse_reference_text(both)[0]["Logical Errors"] == "7"


def test_golden_dated_corpus_readers():
    """Every file in the previously-unswept corpus directories is read:
    81 archive points, 5 per MAX-sweep dir, 21 pre-detection records."""
    from benchmarks.golden_dated import read_archive_points, read_dated_points

    archive = read_archive_points()
    assert len(archive) == 81
    w42 = sorted(w for c, w, _, _, _ in archive if c == (3, 3, 6, 7, 2, 3))
    w610 = sorted(w for c, w, _, _, _ in archive if c == (4, 5, 10, 61, 9, 49))
    # the [[42,0]] archive grid is W=0..7 and 21..42 (the 8..20 band lives
    # in the non-archive [2,3,6,7,2,3]/ dir swept in r4)
    assert w42 == list(range(8)) + list(range(21, 43))
    assert w610 == list(range(1, 52))
    assert all(m == 100 and p == 0.02 for _, _, m, p, _ in archive)
    for dirname in ("11-20-2017_max_50_iterations",
                    "11-20-2017_max_100_iterations",
                    "11-20-2017_max_1000_iterations"):
        pts = read_dated_points(dirname)
        assert sorted(w for w, _, _ in pts) == [1, 2, 3, 4, 5], dirname
    # 21 files, but ResultsCPU_RELEASE_2.txt is 0 bytes (an aborted run —
    # the one corpus file excluded from parity, with this as the reason)
    pre = read_dated_points("11-18-2017_no_logical_error_detection")
    assert len(pre) == 20
    assert all("Logical Errors" in rec for _, rec, _ in pre)


@pytest.mark.parametrize("field,value", [
    ("kernel", "pallas"), ("kernel_tile_batch", 128),
    ("kernel_roll_impl", "shift"), ("kernel_sort_lanes", True)])
def test_bpconfig_rejects_removed_kernel_options(field, value):
    """The decode engines are plain XLA loops; the options that chose the
    removed fused kernels fail with an error naming the option."""
    from qec_ldpc.decoder import BPConfig

    with pytest.raises(TypeError, match=field):
        BPConfig(**{field: value})


def test_runconfig_rejects_removed_kernel_option(tmp_path):
    with pytest.raises(TypeError, match="kernel"):
        RunConfig("code.txt", 1, 1, 10, 10, 0.01, kernel="pallas")
    p = tmp_path / "init.txt"
    p.write_text("code.txt 1 1 10 10 0.01 kernel=pallas\n")
    with pytest.raises(ValueError, match="unknown option 'kernel'"):
        load_init_file(str(p))
    from qec_ldpc.harness.cli import _config_from_flags

    with pytest.raises(ValueError, match="unknown option 'kernel'"):
        _config_from_flags(["--code", "qc:3,3,6,7,2,3", "--kernel", "pallas"])


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is JAX's own business and the
    code sets no other path; otherwise the cache is <checkout>/.jax_cache."""
    import pathlib

    import jax

    from qec_ldpc.harness import cli

    checkout = pathlib.Path(__file__).resolve().parents[1]
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(checkout / ".jax_cache")
    assert cli.compile_cache_dir() == want
    updates = {}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    cli.enable_persistent_compile_cache()
    if env_set:
        assert "jax_compilation_cache_dir" not in updates
    else:
        assert updates["jax_compilation_cache_dir"] == want
    assert updates["jax_persistent_cache_min_entry_size_bytes"] == -1
