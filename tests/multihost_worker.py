"""Worker process for the multi-host loopback test (test_multihost.py).

Each worker owns 4 virtual CPU devices; two workers form an 8-device global
mesh via jax.distributed (loopback coordinator).  Runs one sharded
Monte-Carlo chunk group over the GLOBAL data axis and prints the psum-reduced
counters — which must be identical across processes and equal to a
single-process 8-device run (per-sample keys derive from global device
index, independent of the process partition).

Usage: python multihost_worker.py <coordinator> <num_procs> <proc_id> \
           [chunk | cli <results_dir>]

``cli`` mode runs the full harness ``run_sweep`` end-to-end (the two
processes share <results_dir>, so single-writer gating is observable: the
test asserts exactly one set of results/journal/log records).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=4").strip()

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    coordinator, num_procs, proc_id = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_procs, process_id=proc_id)
    assert jax.process_count() == num_procs
    assert len(jax.devices()) == 4 * num_procs  # global view
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import jax.numpy as jnp

    from qec_ldpc.codes import construct_code
    from qec_ldpc.decoder import BPConfig, CodeGraphs
    from qec_ldpc.parallel import make_mesh, make_sharded_chunk

    mode = sys.argv[4] if len(sys.argv) > 4 else "chunk"
    if mode == "graphchunk":
        # (data=4 x graph=2) mesh with every graph pair SPLIT ACROSS the two
        # processes, so the per-iteration halo all_gather rides the process
        # boundary (the cross-host path of a real multi-host run).  Counters must
        # bit-match a single-process mesh of the same shape (min-sum).
        from qec_ldpc.decoder import BPConfig, CodeGraphs
        from qec_ldpc.parallel import make_graph_sharded_chunk, make_mesh
        from qec_ldpc.sampling.classify import make_rank_basis_test

        code = construct_code(3, 3, 6, 7, 2, 3)
        graphs = CodeGraphs.build(code)
        devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
        half = len(devs) // 2
        # interleave: each data row = (one proc-0 device, one proc-1 device)
        order = [d for pair in zip(devs[:half], devs[half:]) for d in pair]
        mesh = make_mesh(num_data=4, num_graph=2, devices=order)
        fn = make_graph_sharded_chunk(
            mesh, graphs, weight=2,
            cfg=BPConfig(max_iters=20, algorithm="min-sum"),
            batch_per_device=16)
        test = make_rank_basis_test(code)
        counters, _ = fn(test, jax.random.PRNGKey(7), jnp.float32(0.02),
                         jnp.arange(2, dtype=jnp.uint32))
        print("COUNTERS",
              ",".join(map(str, np.asarray(counters).tolist())), flush=True)
        jax.distributed.shutdown()
        return 0

    if mode == "osd":
        # multi-process OSD quality mode (VERDICT r3 #5): device chunk is a
        # process-spanning shard_map; each process OSD-repairs its locally
        # addressable failed lanes; per-chunk failed counters all-reduce
        # across processes.  Single-key sample stream -> counters bit-match
        # the single-process (and single-device) run for min-sum.
        from qec_ldpc.parallel.montecarlo import run_monte_carlo_osd

        code = construct_code(3, 3, 6, 7, 2, 3)
        graphs = CodeGraphs.build(code)
        mesh = make_mesh(num_data=len(jax.devices()))
        cfg = BPConfig(max_iters=15, algorithm="min-sum")
        counters, _ = run_monte_carlo_osd(
            graphs, 4, 128, 0.02, cfg, seed=7, batch_size=64, lam=1,
            relay_retries=1, mesh=mesh)
        print("COUNTERS", ",".join(map(str, np.asarray(counters).tolist())),
              flush=True)
        jax.distributed.shutdown()
        return 0

    if mode in ("cli", "cli_kill"):
        # full harness path over the process-spanning mesh: process-0-only
        # writes, broadcast seed/resume, replicated stats on every process.
        # ``cli_kill`` additionally throttles journal appends (0.2 s each)
        # so the elastic-recovery test has a deterministic mid-sweep window
        # to SIGKILL the workers in, and journals per dispatch group
        # (steps_per_call=1) so several groups exist to interrupt between.
        results_dir = sys.argv[5]
        from qec_ldpc.harness.cli import run_sweep
        from qec_ldpc.harness.config import RunConfig

        kwargs = {}
        if mode == "cli_kill":
            import time as _time

            from qec_ldpc.harness import journal as _journal

            _orig_append = _journal.Journal.append

            def _slow_append(self, rec):
                _orig_append(self, rec)
                _time.sleep(0.2)

            _journal.Journal.append = _slow_append
            kwargs = dict(count=256, steps_per_call=1)
        cfg = RunConfig(
            code_file="qc:3,3,6,7,2,3", weight_start=2, weight_end=2,
            count=kwargs.get("count", 64), max_iterations=20,
            error_probability=0.02,
            seed=11, batch_size=32, algorithm="min-sum",
            steps_per_call=kwargs.get("steps_per_call", 32),
            results_dir=results_dir,
            log_file=os.path.join(results_dir, "log.txt"))
        stats = run_sweep(cfg)[0]
        print(f"STATS {stats.num_errors_tested},{stats.corrected},"
              f"{stats.logical_errors},{stats.syndrome_errors_x},"
              f"{stats.syndrome_errors_z},{stats.convergence_fail_x},"
              f"{stats.convergence_fail_z}", flush=True)
        jax.distributed.shutdown()
        return 0

    code = construct_code(3, 3, 6, 7, 2, 3)
    graphs = CodeGraphs.build(code)
    mesh = make_mesh(num_data=len(jax.devices()))  # global mesh, spanning processes
    chunk_fn = make_sharded_chunk(mesh, graphs, weight=2,
                                  cfg=BPConfig(max_iters=20),
                                  batch_per_device=16)
    counters, iters = chunk_fn(jnp.asarray(code.i_minus_p),
                               jax.random.PRNGKey(7), jnp.float32(0.02),
                               jnp.arange(2, dtype=jnp.uint32))
    print("COUNTERS", ",".join(map(str, np.asarray(counters).tolist())),
          flush=True)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
