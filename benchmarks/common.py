"""Shared benchmark plumbing: compile cache, timing, JSON emission.

Methodology: every benchmark scans enough work on device per dispatch to
dominate the per-dispatch host overhead, warms up once (compile), and
reports the best of ``repeats`` wall-clock timings of a full dispatch
including host materialization of the (tiny) outputs.
"""

from __future__ import annotations

import json
import time


def setup_jax_cache():
    from qec_ldpc.harness.cli import enable_persistent_compile_cache

    enable_persistent_compile_cache()


def best_time(fn, repeats: int = 3) -> float:
    """Best wall-clock of ``repeats`` calls; ``fn`` must materialize its
    outputs on host (np.asarray / float) before returning."""
    fn()  # compile + warm up
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


BASELINE_ITER_SAMPLES_PER_S = 8.87e4  # reference CPU whole-machine, SURVEY §6
