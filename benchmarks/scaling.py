"""Data-parallel scaling of the sharded Monte-Carlo harness over a mesh.

Measures full-pipeline decode throughput at increasing data-axis device
counts using the production shard_map path (per-device fold_in keys, psum
counter reduction — parallel/montecarlo.py).  Emits one JSON line per device
count.

On a multi-GPU host this measures true scaling (1 card -> 1 host -> N
hosts; run one process per host with jax.distributed initialized, see
docs/MULTIHOST.md).  Pass --cpu N to run on N virtual CPU devices instead:
that validates the sharding path end-to-end and reports weak-scaling wall
times, but CPU numbers are functional checks, not device performance.

  python benchmarks/scaling.py --cpu 8 --devices 1,2,4,8 --iters 20
  python benchmarks/scaling.py --devices 1,2,4   # real cards
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from benchmarks.common import best_time, emit, setup_jax_cache


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--code", type=int, nargs=6, default=[4, 5, 10, 61, 9, 49],
                    metavar=("J", "K", "L", "P", "sigma", "tau"))
    ap.add_argument("--cpu", type=int, default=0,
                    help="force CPU with this many virtual devices")
    ap.add_argument("--devices", default="",
                    help="comma-separated device counts (default: 1,2,4,...,all)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--batch-per-device", type=int, default=2048)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--weight", type=int, default=15)
    ap.add_argument("--p", type=float, default=0.01)
    ap.add_argument("--algorithm", default="sum-product")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={args.cpu}").strip()

    setup_jax_cache()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from qec_ldpc.codes import construct_code
    from qec_ldpc.decoder import BPConfig
    from qec_ldpc.decoder.decode import CodeGraphs
    from qec_ldpc.parallel import make_mesh
    from qec_ldpc.parallel.montecarlo import make_sharded_chunk

    devices = jax.devices()
    if args.devices:
        counts = [int(d) for d in args.devices.split(",")]
    else:
        counts, d = [], 1
        while d <= len(devices):
            counts.append(d)
            d *= 2

    code = construct_code(*args.code)
    graphs = CodeGraphs.build(code)
    i_minus_p = jnp.asarray(code.i_minus_p)
    cfg = BPConfig(max_iters=args.iters, check_every=args.iters + 1,
                   algorithm=args.algorithm)
    key = jax.random.PRNGKey(0)
    chunk_ids = jnp.arange(args.chunks, dtype=jnp.uint32)

    base_rate = base_d = None
    for d in counts:
        assert d <= len(devices), f"need {d} devices, have {len(devices)}"
        mesh = make_mesh(num_data=d, devices=devices[:d])
        chunk_fn = make_sharded_chunk(mesh, graphs, args.weight, cfg,
                                      args.batch_per_device)

        def dispatch():
            counters, _ = chunk_fn(i_minus_p, key, jnp.float32(args.p),
                                   chunk_ids)
            counters = np.asarray(counters)
            assert counters[0] == args.chunks * args.batch_per_device * d

        secs = best_time(dispatch)
        samples = args.chunks * args.batch_per_device * d
        rate = samples * args.iters / secs
        if base_rate is None:
            base_rate, base_d = rate, d
        emit({
            "metric": "mc_scaling",
            "devices": d,
            "platform": devices[0].platform,
            "bp_iter_codewords_per_s": round(rate, 1),
            "samples_per_s": round(samples / secs, 1),
            "speedup_vs_base": round(rate / base_rate, 2),
            "parallel_efficiency": round((rate / base_rate) / (d / base_d), 3),
            "unit": (f"weak scaling, {args.batch_per_device} samples/device, "
                     f"fixed {args.iters} iters, {args.algorithm}"),
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())
