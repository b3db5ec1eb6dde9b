"""Debug array dumps + profiling hooks.

Parity with the reference's observability scaffolding:

* ``ArrayOutput.h:6-96`` — append-mode whitespace dumps of 1d/2d int/float
  arrays, used to trace BP internals (e.g. the surviving artifact
  ``diffSyndromeXL.txt``).  ``write_array`` reproduces the format: 2d arrays
  one row per line, space-separated, trailing blank line; 1d arrays one line.
* The dead GPU path's per-phase chrono/cudaEvent timers
  (``QEC_LDPC_CSS.cu:316-328,460-473``) — replaced by ``jax.profiler`` traces
  (:func:`trace`) and a light section timer (:class:`SectionTimers`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


def write_array(path: str, arr, fmt: str | None = None) -> None:
    """Append a 1d/2d array dump in the reference ArrayOutput format."""
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2:
        raise ValueError(f"write_array supports 1d/2d arrays, got shape {a.shape}")
    if fmt is None:
        fmt = "%g" if np.issubdtype(a.dtype, np.floating) else "%d"
    with open(path, "a") as f:
        for row in a:
            f.write(" ".join(fmt % x for x in row) + "\n")
        f.write("\n")


@contextlib.contextmanager
def trace(log_dir: str | None):
    """jax.profiler trace context; no-op when log_dir is None.

    View with TensorBoard / Perfetto (the replacement for the reference's
    .diagsession captures)."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


class SectionTimers:
    """Named wall-clock section accumulators (init/decode/convergence buckets
    of the dead GPU path, QEC_LDPC_CSS.cu:393-412)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [
            f"{name}: {self.totals[name] * 1e3:.2f} ms over {self.counts[name]} call(s)"
            for name in sorted(self.totals)
        ]
        return "\n".join(lines)
