"""Device-mesh configuration for Monte-Carlo scale-out.

The reference is single-process/single-GPU with OpenMP host threads
(``DecoderCPU.h:419-437``); there is no distributed code to mirror.  The
scaling model (SURVEY §2 parallelism checklist, §5):

  * ``data``  axis — Monte-Carlo samples (the primary scaling axis; replaces
    OpenMP thread parallelism and the 32-way batched-GPU sketch
    ``QEC_LDPC_CSS.cu:923-979``)
  * ``graph`` axis — optional Tanner-graph sharding for large lifted codes
    (circulant P-lanes / block-columns split across devices; halo exchange
    by collectives)

Multi-host: ``jax.distributed.initialize`` is called by the launcher when the
JAX coordinator env is present; after that ``jax.devices()`` spans every
process and the same mesh code works unchanged across hosts.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
GRAPH_AXIS = "graph"


def maybe_init_distributed() -> bool:
    """Initialize the multi-host runtime if a coordinator is configured.

    Returns True when running multi-process.  Single-process runs (one host
    with any number of local devices, CPU test meshes) skip initialization.
    """
    if os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get("COORDINATOR_ADDRESS"):
        if jax.process_count() == 1:  # not yet initialized
            jax.distributed.initialize()
        return jax.process_count() > 1
    return False


def make_mesh(num_data: int | None = None, num_graph: int = 1,
              devices=None) -> Mesh:
    """Build a (data, graph) mesh. Defaults to all devices on the data axis."""
    devices = list(devices if devices is not None else jax.devices())
    if num_data is None:
        num_data = len(devices) // num_graph
    if num_data * num_graph > len(devices):
        raise ValueError(
            f"mesh {num_data}x{num_graph} needs {num_data * num_graph} devices, "
            f"have {len(devices)}")
    grid = np.array(devices[: num_data * num_graph]).reshape(num_data, num_graph)
    return Mesh(grid, (DATA_AXIS, GRAPH_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (rows, batch) arrays: batch split over the data axis."""
    return NamedSharding(mesh, P(None, DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
