"""Best-logical-error-rate pipeline: layered min-sum + ensemble relay + OSD.

Demonstrates the full repair stack (docs/DECODERS.md) at a heavy error
weight where plain BP fails on ~20% of samples:

    python examples/quality_pipeline.py [weight]

The same pipeline via the Monte-Carlo driver:
    run_monte_carlo_osd(..., relay_retries=12, lam=60)
or the CLI init extensions ``algorithm=layered-min-sum relay=12 osd=60``.
"""

import pathlib
import sys

# runnable from anywhere without installing the package
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from qec_ldpc.harness.cli import enable_persistent_compile_cache

enable_persistent_compile_cache()

import sys

import jax
import jax.numpy as jnp
import numpy as np

from qec_ldpc.codes import construct_code
from qec_ldpc.decoder import (
    BPConfig,
    CodeGraphs,
    CSSPostprocessor,
    decode_batch,
    relay_decode_batch,
    syndromes_from_errors,
)
from qec_ldpc.sampling import classify_batch_np, sample_weight_w_errors


def main() -> None:
    weight = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    code = construct_code(4, 5, 10, 61, 9, 49)
    graphs = CodeGraphs.build(code)
    batch, p = 1024, 0.02
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(0), code.n, weight, batch)
    sx, sz = syndromes_from_errors(graphs, xe.astype(jnp.int32),
                                   ze.astype(jnp.int32))

    cfg = BPConfig(max_iters=100, algorithm="layered-min-sum",
                   return_soft=True)

    def report(name, dx, dz, ec):
        c = classify_batch_np(code.i_minus_p, np.asarray(xe), np.asarray(ze),
                              dx, dz, ec)
        print(f"{name:24s} corrected {c[3]:5d}  logical {c[6]:5d}  "
              f"syndrome-fail {c[4] + c[5]:5d}   (of {c[0]})")

    # stage 0: plain layered BP
    res = decode_batch(graphs, sx, sz, p, cfg)
    report("layered BP", np.asarray(res.decisions_x),
           np.asarray(res.decisions_z), np.asarray(res.error_code))

    # stage 1: + on-device ensemble relay
    res_r, _, _ = relay_decode_batch(graphs, sx, sz, p, jax.random.PRNGKey(7),
                                     cfg, retries=12)
    report("+ relay(12)", np.asarray(res_r.decisions_x),
           np.asarray(res_r.decisions_z), np.asarray(res_r.error_code))

    # stage 2: + host OSD with combination sweep on whatever remains
    dx, dz, ec = CSSPostprocessor(graphs, lam=60).apply(
        np.asarray(sx), np.asarray(sz), res_r)
    report("+ OSD(lam=60)", dx, dz, ec)


if __name__ == "__main__":
    main()
