"""Multi-host logic via jax.distributed loopback (SURVEY §4: multi-chip tests
runnable on CPU; §5 distributed backend).

Two OS processes, 4 virtual CPU devices each, form an 8-device global mesh
through a loopback coordinator — the same code path a real multi-host
cluster uses (jax.distributed + process-spanning Mesh + psum across hosts).  The
psum-reduced counters must agree across processes AND bit-match a
single-process 8-device run, because per-sample PRNG keys derive from the
global device index (partition-independent reproducibility — the design that
replaces the reference's thread-count-dependent locked RNG,
DecoderCPU.h:411,448-459).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_two_process_loopback_matches_single_process(small_code, small_graphs):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, f"127.0.0.1:{port}", "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    counters = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("COUNTERS")][0]
        counters.append([int(x) for x in line.split()[1].split(",")])
    assert counters[0] == counters[1], "processes disagree on psum counters"

    # single-process 8-device reference run: identical statistics
    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.parallel import make_mesh, make_sharded_chunk

    mesh = make_mesh(num_data=8)
    chunk_fn = make_sharded_chunk(mesh, small_graphs, weight=2,
                                  cfg=BPConfig(max_iters=20),
                                  batch_per_device=16)
    ref, _ = chunk_fn(jnp.asarray(small_code.i_minus_p),
                      jax.random.PRNGKey(7), jnp.float32(0.02),
                      jnp.arange(2, dtype=jnp.uint32))
    assert counters[0] == np.asarray(ref).tolist()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_two_process_cli_single_writer(tmp_path):
    """run_sweep over a 2-process loopback mesh: both processes compute the
    same replicated statistics, but only process 0 writes — the shared
    results_dir must hold exactly ONE results record, ONE journal chunk
    sequence, and ONE log (VERDICT r2 #6; main.cu:45-52,100)."""
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    results_dir = str(tmp_path / "shared_results")
    os.makedirs(results_dir, exist_ok=True)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, f"127.0.0.1:{port}", "2", str(i),
             "cli", results_dir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    stats = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("STATS")][0]
        stats.append(line.split()[1])
    assert stats[0] == stats[1], "processes disagree on replicated stats"
    assert stats[0].split(",")[0] == "64"

    # exactly one record in the (single) results file
    results = [f for f in os.listdir(results_dir)
               if f.endswith(".txt") and "_W_2_" in f]
    assert len(results) == 1
    from qec_ldpc.harness import parse_reference_text

    records = parse_reference_text(
        open(os.path.join(results_dir, results[0])).read())
    assert len(records) == 1, f"duplicate result records: {len(records)}"
    # journal holds each chunk group exactly once
    journal_lines = open(os.path.join(results_dir, "journal.jsonl")).read().splitlines()
    import json

    chunks = [json.loads(ln)["chunk"] for ln in journal_lines if ln.strip()]
    assert len(chunks) == len(set(chunks)), f"duplicate journal chunks: {chunks}"
    # single log header (one writer appended one timestamp block)
    log_text = open(os.path.join(results_dir, "log.txt")).read()
    assert log_text.count("Run complete.") == 1


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_two_process_graph_sharded_statistics(small_code):
    """Graph-parallel Monte-Carlo statistics with the graph axis SPLIT
    ACROSS processes: every CN-halo all_gather crosses the jax.distributed
    boundary (the cross-host path).  Counters must bit-match a single-process
    (data=4, graph=2) mesh — min-sum cross-shard reductions are exact and
    sample keys depend only on the data index."""
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, f"127.0.0.1:{port}", "2", str(i),
             "graphchunk"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    counters = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("COUNTERS")][0]
        counters.append([int(x) for x in line.split()[1].split(",")])
    assert counters[0] == counters[1]

    # single-process reference with the same mesh shape
    import jax.numpy as jnp

    from qec_ldpc.decoder import BPConfig, CodeGraphs
    from qec_ldpc.parallel import make_graph_sharded_chunk, make_mesh
    from qec_ldpc.sampling.classify import make_rank_basis_test

    graphs = CodeGraphs.build(small_code)
    mesh = make_mesh(num_data=4, num_graph=2)
    fn = make_graph_sharded_chunk(
        mesh, graphs, weight=2,
        cfg=BPConfig(max_iters=20, algorithm="min-sum"), batch_per_device=16)
    ref, _ = fn(make_rank_basis_test(small_code), jax.random.PRNGKey(7),
                jnp.float32(0.02), jnp.arange(2, dtype=jnp.uint32))
    assert counters[0] == np.asarray(ref).tolist()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_two_process_osd_quality_mode(small_graphs):
    """Multi-process OSD (VERDICT r3 #5): the quality mode runs across a
    2-process loopback mesh — each process repairs its locally addressable
    failed lanes, failed counters all-reduce per chunk — and the post-repair
    counters bit-match the SINGLE-DEVICE run (single-key sample stream +
    exact min-sum decode + deterministic OSD)."""
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, f"127.0.0.1:{port}", "2", str(i), "osd"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    counters = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("COUNTERS")][0]
        counters.append([int(x) for x in line.split()[1].split(",")])
    assert counters[0] == counters[1], "processes disagree on OSD counters"

    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.parallel.montecarlo import run_monte_carlo_osd

    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    ref, _ = run_monte_carlo_osd(small_graphs, 4, 128, 0.02, cfg, seed=7,
                                 batch_size=64, lam=1, relay_retries=1)
    assert counters[0] == np.asarray(ref).tolist()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_elastic_recovery_kill_mid_sweep(tmp_path):
    """Elastic recovery beyond clean restart (VERDICT r4 #8): SIGKILL both
    workers MID-SWEEP (first the non-writer, then the journal-writing
    process 0), restart the job against the same results_dir, and assert
    the resumed run's final counters bit-match an uninterrupted run.

    Works because chunk groups are idempotent (per-chunk keys derive from
    the global chunk index) and the journal is an fsync'd append-only log
    the resume path reads back — a record is written only AFTER its group's
    counters accumulate, so a kill between the two just re-runs that group.
    """
    import json
    import time

    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    results_dir = str(tmp_path / "elastic_results")
    os.makedirs(results_dir, exist_ok=True)
    journal_path = os.path.join(results_dir, "journal.jsonl")

    def launch():
        port = _free_port()
        return [
            subprocess.Popen(
                [sys.executable, worker, f"127.0.0.1:{port}", "2", str(i),
                 "cli_kill", results_dir],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env)
            for i in range(2)
        ]

    def journal_lines():
        try:
            return [ln for ln in open(journal_path).read().splitlines()
                    if ln.strip()]
        except FileNotFoundError:
            return []

    # ---- run 1: kill mid-sweep ----
    procs = launch()
    deadline = time.time() + 280
    while time.time() < deadline:
        if len(journal_lines()) >= 2:
            break
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.05)
    n_before = len(journal_lines())
    # kill the exact PIDs we own: non-writer first, then the writer
    procs[1].kill()
    time.sleep(0.5)
    procs[0].kill()
    for p in procs:
        p.wait(timeout=60)
    # 256 samples / 32 batch = 8 dispatch groups: the kill must have landed
    # mid-sweep (at least one group journaled, not all)
    assert 1 <= n_before < 8, (
        f"kill window missed: {n_before} journal lines "
        f"(workers exited: {[p.returncode for p in procs]})")

    # ---- run 2: same config + results_dir -> journal resume ----
    procs = launch()
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        assert p.returncode == 0, f"resumed worker failed:\n{out}\n{err}"
        outs.append(out)
    stats = [next(ln for ln in o.splitlines() if ln.startswith("STATS"))
             .split()[1] for o in outs]
    assert stats[0] == stats[1]
    # the resumed run logged that it resumed (not restarted from scratch)
    log_text = open(os.path.join(results_dir, "log.txt")).read()
    assert "resuming W=2" in log_text
    # every dispatch group journaled exactly once across both runs
    chunks = [json.loads(ln)["chunk"] for ln in journal_lines()]
    assert sorted(chunks) == list(range(8)), chunks

    # ---- uninterrupted reference: same config, fresh dir, in-process ----
    from qec_ldpc.harness.cli import run_sweep
    from qec_ldpc.harness.config import RunConfig

    ref_dir = str(tmp_path / "ref_results")
    ref = run_sweep(RunConfig(
        code_file="qc:3,3,6,7,2,3", weight_start=2, weight_end=2,
        count=256, max_iterations=20, error_probability=0.02,
        seed=11, batch_size=32, algorithm="min-sum", steps_per_call=1,
        results_dir=ref_dir, log_file=os.path.join(ref_dir, "log.txt")))[0]
    expected = (f"{ref.num_errors_tested},{ref.corrected},"
                f"{ref.logical_errors},{ref.syndrome_errors_x},"
                f"{ref.syndrome_errors_z},{ref.convergence_fail_x},"
                f"{ref.convergence_fail_z}")
    assert stats[0] == expected
