"""Graph-parallel Monte-Carlo statistics demo (BASELINE config 5).

Runs the flagship [[610,61]] code's statistics pipeline over a
(data x graph) mesh — the Tanner graphs themselves sharded block-column-wise
across the graph axis — and shows the exact-decoder counters bit-matching a
data-only mesh of the same data size.  Works anywhere: on a multi-GPU host
the mesh spans real cards; on CPU it uses virtual devices (set below).

    python examples/graph_parallel_demo.py
"""

import os
import sys

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
# QEC_DEMO_PLATFORM=cuda to run on a real multi-GPU host; defaults to the
# 8-virtual-device CPU mesh (the in-process config update below is what
# actually decides)
platform = os.environ.get("QEC_DEMO_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = platform

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", platform)

import numpy as np

from qec_ldpc.codes import construct_code
from qec_ldpc.decoder import BPConfig, CodeGraphs
from qec_ldpc.parallel import make_mesh, run_monte_carlo

code = construct_code(4, 5, 10, 61, 9, 49)
graphs = CodeGraphs.build(code)
cfg = BPConfig(max_iters=100, algorithm="min-sum")  # exact under sharding
devices = jax.devices()
print(f"{len(devices)} devices ({devices[0].platform})")

kw = dict(weight=30, count=512, error_probability=0.01, cfg=cfg, seed=7,
          batch_size=128)

# data-only mesh: 4 devices decode whole graphs
data_mesh = make_mesh(num_data=4, num_graph=1, devices=devices[:4])
c_data, it_data = run_monte_carlo(graphs, mesh=data_mesh, **kw)

# (data=4 x graph=2): each graph is split over 2 devices (5 block-columns
# each); CN halo partials ride one all_gather per iteration
graph_mesh = make_mesh(num_data=4, num_graph=2, devices=devices)
c_graph, it_graph = run_monte_carlo(graphs, mesh=graph_mesh, **kw)

print("data-only counters:", np.asarray(c_data).tolist())
print("graph-parallel    :", np.asarray(c_graph).tolist())
assert np.array_equal(np.asarray(c_data), np.asarray(c_graph))
assert it_data == it_graph
print(f"bit-match OK; corrected fraction = {c_graph[3] / c_graph[0]:.4f}")
