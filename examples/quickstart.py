"""Quickstart: construct the flagship code, decode a batch, read the outcome.

Runs on whatever JAX backend is available (GPU or CPU; the decode engines
are plain XLA loops).  See docs/DECODERS.md for algorithm selection.

    python examples/quickstart.py
"""

import pathlib
import sys

# runnable from anywhere without installing the package
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from qec_ldpc.harness.cli import enable_persistent_compile_cache

enable_persistent_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

from qec_ldpc.codes import construct_code
from qec_ldpc.decoder import (
    BPConfig,
    CodeGraphs,
    decode_batch,
    syndromes_from_errors,
)
from qec_ldpc.sampling import classify_batch, sample_weight_w_errors


def main() -> None:
    code = construct_code(4, 5, 10, 61, 9, 49)  # the [[610,61]] flagship
    graphs = CodeGraphs.build(code)
    print(f"code: {code}  (n={code.n}, checks: {code.num_eqs_x}+{code.num_eqs_z})")

    batch = 1024
    xe, ze = sample_weight_w_errors(jax.random.PRNGKey(0), code.n, 15, batch)
    sx, sz = syndromes_from_errors(graphs, xe.astype(jnp.int32),
                                   ze.astype(jnp.int32))

    res = decode_batch(graphs, sx, sz, 0.01, BPConfig(max_iters=100))

    counters = np.asarray(classify_batch(
        jnp.asarray(code.i_minus_p),
        xe.astype(jnp.int32), ze.astype(jnp.int32),
        res.decisions_x.astype(jnp.int32), res.decisions_z.astype(jnp.int32),
        res.error_code))
    tested, _, _, corrected, syn_x, syn_z, logical, conv_x, conv_z = counters
    print(f"tested {tested}: corrected {corrected}, logical {logical}, "
          f"syndrome-fail {syn_x}+{syn_z}, convergence-fail {conv_x}+{conv_z}")


if __name__ == "__main__":
    main()
