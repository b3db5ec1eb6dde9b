"""Experiment CLI: init-file-compatible weight-sweep driver.

Device re-design of ``main.cu:43-118``: opens an append-mode run log, parses the
init file, loads (or constructs) the code, sweeps weights w..W, runs the
Monte-Carlo harness for each, and appends a CodeStatistics text dump to
``results/<code>_W_<w>_MAX_<M>_p_<p>.txt`` with the reference's exact record
format and file naming.  Framework extensions: seeded runs, JSONL progress
journal with chunk-exact resume, device-mesh scale-out, min-sum selection,
structured logging with device/topology metadata.

Usage:
    python -m qec_ldpc.harness.cli <init-file>
    python -m qec_ldpc.harness.cli --code J,K,L,P,sigma,tau [options...]
"""

from __future__ import annotations

import datetime
import os
import random
import sys
import time
from pathlib import Path

import jax

from qec_ldpc.codes import (
    bicycle_code,
    construct_code,
    hgp_code,
    known_bicycle_code,
    load_code_file,
    toric_code,
)
from qec_ldpc.decoder import CodeGraphs
from qec_ldpc.harness import debug
from qec_ldpc.harness.config import RunConfig, format_result_filename, load_init_file
from qec_ldpc.harness.journal import Journal
from qec_ldpc.harness.stats import CodeStatistics
from qec_ldpc.parallel import (
    make_mesh,
    maybe_init_distributed,
    run_monte_carlo,
    run_monte_carlo_osd,
)
from qec_ldpc.sampling.classify import make_rank_basis_test


def _log(fh, msg: str) -> None:
    """Append + echo a run-log line; no-op on non-zero processes (fh=None —
    single-writer semantics, main.cu:45-52)."""
    if fh is None:
        return
    line = f"{msg}"
    print(line)
    fh.write(line + "\n")
    fh.flush()


def _broadcast_resume(start_chunk: int, init_counters, init_iters: int):
    """Replicate process 0's journal resume state to every process.

    Multi-host runs write journal/results from process 0 only; the other
    processes must still execute the same chunk-group sequence (the sharded
    chunk is a collective program — divergent start chunks would deadlock),
    so the resume cursor is broadcast.  Encoded as fixed-shape arrays for
    ``broadcast_one_to_all``.
    """
    import numpy as np
    from jax.experimental import multihost_utils

    from qec_ldpc.sampling import NUM_COUNTERS

    has = init_counters is not None
    counters = (np.asarray(init_counters, dtype=np.int64) if has
                else np.zeros(NUM_COUNTERS, dtype=np.int64))
    packed = np.concatenate([
        np.array([start_chunk, init_iters, int(has)], dtype=np.int64),
        counters])
    packed = np.asarray(multihost_utils.broadcast_one_to_all(packed))
    start_chunk, init_iters, has = (int(packed[0]), int(packed[1]),
                                    bool(packed[2]))
    return start_chunk, (packed[3:] if has else None), init_iters


#: fixed default cache location: a per-process or temporary path would
#: never be found again by the next run
DEFAULT_COMPILE_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when set (JAX reads it itself), else ``<checkout>/.jax_cache``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(DEFAULT_COMPILE_CACHE))


def enable_persistent_compile_cache() -> None:
    """Persistent XLA compile cache at :func:`compile_cache_dir`; the one
    cache rule shared by the CLI, the benchmarks and ``chip_smoke.py``.

    CPU backend: skipped.  CPU compiles are fast, and serializing large CPU
    executables for the cache has been observed to SEGFAULT inside XLA's
    executable serializer (checkify-instrumented while_loop programs under
    the 8-virtual-device test mesh) — the cache write path, not our code."""
    if jax.default_backend() == "cpu":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def load_code_and_graphs(spec: str):
    """Resolve a codeFile spec to (code, graphs).  Forms:

    * a path to a reference-format code file (``Quantum_LDPC_Code.h:43-74``);
    * ``qc:J,K,L,P,sigma,tau`` — programmatic Hagiwara–Imai construction
      (``QEC_LDPC_CSS.cu:26-131``);
    * ``bb:[[144,12,12]]`` (published instance) or
      ``bb:l=12,m=6,A=x3+y+y2,B=y3+x+x2`` — bivariate bicycle codes
      (codes/bicycle.py) on lifted graphs;
    * ``toric:d`` — the [[2d²,2,d]] toric code, or
      ``hgp:n1=7,n2=7,h1=1+x+x3,h2=1+y+y3`` — hypergraph products of
      circulant classical codes (codes/hypergraph.py) on lifted graphs.
    """
    def bad_spec(form: str, exc: Exception):
        return ValueError(
            f"malformed code spec {spec!r}: expected {form} ({exc})")

    if spec.startswith("toric:"):
        try:
            code = toric_code(int(spec[len("toric:"):]))
        except (ValueError, TypeError) as e:
            raise bad_spec("toric:<d> with integer distance d >= 2", e) from e
        return code, code.build_graphs()
    if spec.startswith("hgp:"):
        try:
            kv = dict(t.split("=", 1) for t in spec[4:].split(","))
            code = hgp_code(int(kv["n1"]), int(kv["n2"]), kv["h1"], kv["h2"])
        except (KeyError, ValueError, TypeError) as e:
            raise bad_spec(
                "hgp:n1=<int>,n2=<int>,h1=<poly>,h2=<poly> "
                "(e.g. hgp:n1=7,n2=7,h1=1+x+x3,h2=1+y+y3)", e) from e
        return code, code.build_graphs()
    if spec.startswith("bb:"):
        body = spec[3:]
        try:
            if body.startswith("[["):
                code = known_bicycle_code(body)
            else:
                kv = dict(t.split("=", 1) for t in body.split(","))
                code = bicycle_code(int(kv["l"]), int(kv["m"]),
                                    kv["A"], kv["B"])
        except (KeyError, ValueError, TypeError) as e:
            raise bad_spec(
                "bb:[[n,k,d]] (a published instance) or "
                "bb:l=<int>,m=<int>,A=<poly>,B=<poly> "
                "(e.g. bb:l=12,m=6,A=x3+y+y2,B=y3+x+x2)", e) from e
        return code, code.build_graphs()
    if spec.startswith("qc:"):
        try:
            vals = [int(x) for x in spec[3:].replace(",", " ").split()]
            code = construct_code(*vals)
        except (ValueError, TypeError) as e:
            raise bad_spec("qc:J,K,L,P,sigma,tau (six integers)", e) from e
        return code, CodeGraphs.build(code)
    code = load_code_file(spec)
    return code, CodeGraphs.build(code)


def resolve_logical_test_for_code(code, logical_test: str):
    """The CLI's logical-test operand: the rank-basis test (bit-identical to
    the dense iMinusP matvec at O(rank * n) memory, VERDICT r2 #2) — unless
    a file-loaded code ships an iMinusP with a DIFFERENT kernel than the
    PCM-derived annihilator, in which case the file's matrix wins (advisor
    finding r3: a deliberately different shipped matrix must not be
    silently reinterpreted).  Equivalence is a one-time GF(2) rank check:
    same rowspace <=> same kernel <=> identical classification.

    Returns ``(test_operand, note_or_None)``.
    """
    import numpy as np

    test = make_rank_basis_test(code, logical_test)
    shipped = getattr(code, "_i_minus_p", None)
    if shipped is None or logical_test != "reference":
        return test, None
    from qec_ldpc.codes.construction import build_i_minus_p, gf2_rref

    shipped = np.asarray(shipped) % 2
    ours = build_i_minus_p(code.pcm_x, code.pcm_z)
    r_ship = len(gf2_rref(shipped)[1])
    r_ours = len(gf2_rref(ours)[1])
    r_both = len(gf2_rref(np.concatenate([shipped, ours]))[1])
    if r_ship == r_ours == r_both:
        return test, None
    import jax.numpy as jnp

    return jnp.asarray(shipped), (
        f"file-shipped iMinusP differs from the PCM-derived annihilator "
        f"(ranks {r_ship}/{r_ours}/joint {r_both}); classifying with the "
        f"FILE's matrix")


def run_sweep(cfg: RunConfig) -> list[CodeStatistics]:
    # distributed FIRST: jax.distributed.initialize must run before anything
    # touches the backend, and enable_persistent_compile_cache calls
    # jax.default_backend() (review finding r3 — the loopback test masked
    # this because the worker initializes distributed itself)
    maybe_init_distributed()
    enable_persistent_compile_cache()
    # single-writer output hygiene (main.cu:45-52,100): only process 0 opens
    # the run log / journal / results files — counters are replicated, so
    # under jax.distributed every process would otherwise write duplicates
    # to a shared filesystem
    is_main = jax.process_index() == 0
    log = None
    if is_main:
        os.makedirs(cfg.results_dir, exist_ok=True)
        log = open(cfg.log_file, "a")  # append-mode run log (main.cu:45-52)
        log.write("\n" + datetime.datetime.now().ctime() + "\n")

    code, graphs = load_code_and_graphs(cfg.code_file)
    i_minus_p, note = resolve_logical_test_for_code(code, cfg.logical_test)
    if note:
        _log(log, f"  NOTE: {note}")
    bp_cfg = cfg.bp_config()
    seed = cfg.seed if cfg.seed is not None else random.SystemRandom().getrandbits(32)
    if jax.process_count() > 1 and cfg.seed is None:
        # all processes must agree on the run seed (sample keys derive
        # from it); take process 0's draw
        import numpy as _np
        from jax.experimental import multihost_utils

        seed = int(multihost_utils.broadcast_one_to_all(
            _np.int64(seed)))

    devices = jax.devices()
    if cfg.num_graph > 1:
        # (data x graph) mesh: Tanner-graph sharding (BASELINE config 5).
        # Both quality modes compose: relay runs graph-sharded damped
        # retries inside the shard_map, host OSD consumes gathered soft
        # outputs (circulant codes; parallel/mc_graph.py raises with
        # guidance for lifted-code combinations it cannot serve).
        if len(devices) < cfg.num_graph:
            raise ValueError(
                f"num_graph={cfg.num_graph} needs at least that many "
                f"devices, have {len(devices)}")
        num_data = len(devices) // cfg.num_graph
        mesh = make_mesh(num_data=num_data, num_graph=cfg.num_graph,
                         devices=devices[: num_data * cfg.num_graph])
    else:
        mesh = make_mesh() if (cfg.use_mesh and len(devices) > 1) else None
    _log(log, f"Initializing run for code {code} on {len(devices)} device(s) "
              f"({devices[0].platform}"
              + (f"; mesh data={dict(mesh.shape)['data']}"
                 f" x graph={dict(mesh.shape)['graph']}" if mesh is not None
                 else "")
              + f"); seed={seed}")

    journal = (Journal(os.path.join(cfg.results_dir, "journal.jsonl"))
               if is_main else None)

    # multi-WEIGHT sweeps ride the dynamic sampler: one compiled program for
    # the whole sweep instead of one per weight.  Single-point runs keep the static sampler, so their sample streams (and committed
    # artifacts, e.g. the literal init.txt run) stay reproducible.
    sweep = cfg.sweep_points()
    weights = sorted({w for w, _ in sweep})
    weight_cap = None
    if (len(weights) > 1 and cfg.error_model == "weight"
            and cfg.num_graph == 1 and cfg.osd < 0):
        weight_cap = -(-max(weights) // 8) * 8  # pad to a multiple of 8

    all_stats: list[CodeStatistics] = []
    with debug.trace(cfg.profile_dir or None):
        for i, (w, p) in enumerate(sweep):
            # the run_id must pin EVERYTHING a resumed continuation depends
            # on: chunk sequencing (batch_size, steps_per_call — start_chunk
            # counts dispatch groups) and counter semantics (logical_test);
            # a mismatch must start fresh, never blend
            # spc must be the EFFECTIVE dispatch-group size (run_monte_carlo
            # may substitute a divisor of the chunk count; start_chunk counts
            # dispatch groups, so a different grouping must get a fresh
            # run_id — advisor r4).  OSD mode journals per chunk, not per
            # group, so its sequencing is spc-independent; keep the
            # configured value there for continuity with existing journals.
            spc_eff = cfg.steps_per_call
            if cfg.osd < 0:
                from qec_ldpc.parallel.montecarlo import (
                    effective_steps_per_call,
                )

                spc_eff = effective_steps_per_call(
                    cfg.count, cfg.batch_size, cfg.steps_per_call, mesh)
            run_id = (f"{code}|COUNT={cfg.count}|MAX={cfg.max_iterations}"
                      f"|p={p:g}|seed={seed}|bs={cfg.batch_size}"
                      f"|spc={spc_eff}")
            if cfg.osd >= 0:
                run_id += f"|osd={cfg.osd}"
            if cfg.relay > 0:
                from qec_ldpc.decoder.relay import GAMMA_HIGH, GAMMA_LOW

                # the gamma range shapes the retry streams; a range change
                # (like r3 -> r4's retuning) must never blend with a journal
                # written under the old range (advisor r4)
                run_id += (f"|relay={cfg.relay}"
                           f"|g={GAMMA_LOW:g}:{GAMMA_HIGH:g}")
            if cfg.num_graph > 1:
                # graph-sharded sum-product reassociates (statistically but
                # not bit-equivalent), so a continuation must not blend
                run_id += f"|ng={cfg.num_graph}"
            if weight_cap is not None:
                # the dynamic sampler's draw stream differs from the static
                # one, so a continuation must not blend across modes
                run_id += f"|wcap={weight_cap}"
            if cfg.logical_test != "reference":
                run_id += f"|lt={cfg.logical_test}"
            fname = format_result_filename(str(code), w, cfg.max_iterations, p)
            out_path = os.path.join(cfg.results_dir, fname)
            _log(log, out_path)

            start_chunk, init_counters, init_iters = (
                journal.resume_state(run_id, w) if journal is not None
                else (0, None, 0))
            if jax.process_count() > 1:
                start_chunk, init_counters, init_iters = _broadcast_resume(
                    start_chunk, init_counters, init_iters)
            if start_chunk:
                _log(log, f"  resuming W={w} p={p:g} at chunk {start_chunk}")

            def on_chunk(c, num_chunks, counters, iters, _w=w, _rid=run_id):
                if journal is None:
                    return
                journal.append({
                    "run_id": _rid, "weight": _w, "chunk": c,
                    "counters": [int(x) for x in counters], "iters": iters,
                })

            t0 = time.perf_counter()
            if cfg.osd >= 0:
                # host-OSD quality mode: relay (optional) then OSD per chunk.
                # Chunks shard over the mesh's data axis via GSPMD (one key
                # per chunk -> partition-independent counters) and journal
                # POST-repair counters per chunk for chunk-exact resume.
                counters, bp_iters = run_monte_carlo_osd(
                    graphs, w, cfg.count, p, bp_cfg, seed + i,
                    batch_size=cfg.batch_size, lam=cfg.osd,
                    error_model=cfg.error_model, progress=on_chunk,
                    relay_retries=cfg.relay, i_minus_p=i_minus_p,
                    mesh=mesh, start_chunk=start_chunk,
                    init_counters=init_counters,
                )
            else:
                # standard path; relay (if any) stays pure-device, so mesh
                # scale-out, device scans, and journal resume all compose
                counters, bp_iters = run_monte_carlo(
                    graphs, w, cfg.count, p, bp_cfg, seed + i,
                    batch_size=cfg.batch_size, mesh=mesh,
                    error_model=cfg.error_model,
                    progress=on_chunk, start_chunk=start_chunk,
                    init_counters=init_counters,
                    steps_per_call=cfg.steps_per_call,
                    relay_retries=cfg.relay, i_minus_p=i_minus_p,
                    weight_cap=weight_cap,
                )
            duration_us = int((time.perf_counter() - t0) * 1e6)

            stats = CodeStatistics.from_counters(
                code, seed + i, w, counters, duration_us,
                total_bp_iterations=bp_iters + init_iters,
                num_devices=len(devices))
            all_stats.append(stats)
            # append-mode per-weight results file, process 0 only (main.cu:100)
            if is_main:
                with open(out_path, "a") as f:
                    f.write(stats.to_reference_text() + "\n\n")
            _log(log, f"  W={w} p={p:g}: {stats.num_errors_tested} samples, "
                      f"corrected={stats.corrected}, "
                      f"logical={stats.logical_errors}, "
                      f"{stats.samples_per_second:,.0f} samples/s")

    _log(log, "Run complete.")
    if log is not None:
        log.close()
    return all_stats


def _parse_flag_tokens(argv: list[str]) -> dict[str, str]:
    """``--key value`` / ``--key=value`` tokens -> {field: raw value},
    mapping the reference init file's positional names to RunConfig fields."""
    alias = {"code": "code_file", "w": "weight_start", "W": "weight_end",
             "count": "count", "max": "max_iterations",
             "p": "error_probability"}
    values: dict[str, str] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --flag, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"flag {tok!r} needs a value")
            val = argv[i + 1]
            i += 1
        values[alias.get(key, key)] = val
        i += 1
    return values


def _apply_flag_values(cfg: RunConfig, values: dict[str, str]) -> RunConfig:
    from qec_ldpc.harness.config import apply_option

    for k, v in values.items():
        try:
            apply_option(cfg, k, v)
        except ValueError as e:
            raise ValueError(f"--{k}: {e}") from e
    return cfg


def _config_from_flags(argv: list[str]) -> RunConfig:
    """Flag form: ``--code <spec> [--w N] [--W N] [--count N] [--max N]
    [--p F] [--<any-RunConfig-field> value]`` — the init file's positional
    line expressed as flags, for ad-hoc runs without writing a file."""
    values = _parse_flag_tokens(argv)
    if "code_file" not in values:
        raise ValueError("--code <spec> is required")
    weight_start = int(values.pop("weight_start", 1))
    weight_end = int(values.pop("weight_end", weight_start))
    if weight_end < weight_start:
        raise ValueError(
            f"--W {weight_end} is below --w {weight_start}")
    cfg = RunConfig(
        code_file=values.pop("code_file"),
        weight_start=weight_start,
        weight_end=weight_end,
        count=int(values.pop("count", 10000)),
        max_iterations=int(values.pop("max_iterations", 100)),
        error_probability=float(values.pop("error_probability", 0.01)),
    )
    return _apply_flag_values(cfg, values)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Usage: python -m qec_ldpc.harness.cli <init-file> "
              "[--<field> value ...]\n"
              "       python -m qec_ldpc.harness.cli --code <spec> "
              "[--w N --W N --count N --max N --p F --<field> value ...]",
              file=sys.stderr)
        return 2
    if argv[0].startswith("--"):
        cfg = _config_from_flags(argv)
    else:
        # init-file form; trailing --flag overrides layer on top, so the
        # reference's LITERAL init.txt can run with repo-local output dirs:
        #   cli QEC_LDPC/init.txt --results_dir out/
        cfg = load_init_file(argv[0])
        overrides = _parse_flag_tokens(argv[1:])
        overrides.pop("code_file", None)  # the init file owns the code spec
        _apply_flag_values(cfg, overrides)
    try:
        run_sweep(cfg)
    except Exception as e:
        # reference semantics: failures are appended to the run log before
        # the process exits (main.cu:106-112); single-writer under
        # multi-host (only process 0 touches the shared log)
        try:
            if jax.process_index() == 0:
                with open(cfg.log_file, "a") as f:
                    f.write(f"{datetime.datetime.now().ctime()} ERROR: {e}\n")
        except Exception:
            pass
        raise
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
