from qec_ldpc.parallel.mesh import (
    DATA_AXIS,
    GRAPH_AXIS,
    batch_sharding,
    make_mesh,
    maybe_init_distributed,
    replicated,
)
from qec_ldpc.parallel.graph_sharded import make_graph_sharded_decoder
from qec_ldpc.parallel.lifted_sharded import make_lifted_sharded_decoder
from qec_ldpc.parallel.mc_graph import (
    make_graph_sharded_arrays_chunk,
    make_graph_sharded_chunk,
)
from qec_ldpc.parallel.montecarlo import (
    make_sharded_chunk,
    mc_chunk,
    mc_chunk_arrays,
    run_monte_carlo,
    run_monte_carlo_osd,
)

__all__ = [
    "make_graph_sharded_decoder",
    "make_lifted_sharded_decoder",
    "DATA_AXIS",
    "GRAPH_AXIS",
    "make_mesh",
    "maybe_init_distributed",
    "batch_sharding",
    "replicated",
    "mc_chunk",
    "mc_chunk_arrays",
    "make_sharded_chunk",
    "make_graph_sharded_chunk",
    "make_graph_sharded_arrays_chunk",
    "run_monte_carlo",
    "run_monte_carlo_osd",
]
