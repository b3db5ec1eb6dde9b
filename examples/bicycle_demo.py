"""Bivariate bicycle codes end to end: construct, decode, repair, search.

Runs on whatever backend JAX finds (GPU or CPU).  Usage:

    python examples/bicycle_demo.py [published-label]   # default [[144,12,12]]
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

from qec_ldpc.codes import find_bicycle_codes, known_bicycle_code
from qec_ldpc.decoder import BPConfig, decode_batch, syndromes_from_errors
from qec_ldpc.decoder.osd import CSSPostprocessor
from qec_ldpc.sampling import classify_batch, sample_depolarizing_errors
from qec_ldpc.sampling.classify import classify_batch_np


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else "[[144,12,12]]"
    code = known_bicycle_code(label)
    graphs = code.build_graphs()
    print(f"code: {code}  (n={code.n}, k={code.k_logical})")

    # --- decode a batch of depolarizing errors with flooding min-sum -------
    batch, p = 512, 0.03
    xe, ze = sample_depolarizing_errors(jax.random.PRNGKey(0), code.n, p, batch)
    xe, ze = xe.astype(jnp.int32), ze.astype(jnp.int32)
    sx, sz = syndromes_from_errors(graphs, xe, ze)
    cfg = BPConfig(max_iters=100, algorithm="min-sum", return_soft=True)
    res = decode_batch(graphs, sx, sz, p, cfg)
    c = np.asarray(classify_batch(jnp.asarray(code.i_minus_p), xe, ze,
                                  res.decisions_x.astype(jnp.int32),
                                  res.decisions_z.astype(jnp.int32),
                                  res.error_code))
    print(f"BP alone     @ p={p}: corrected {c[3]}/{c[0]}, "
          f"syndrome-fail {c[4] + c[5]}, logical {c[6]}")

    # --- BP+OSD: repair the failures on host -------------------------------
    dx, dz, ec = CSSPostprocessor(graphs, lam=20).apply(
        np.asarray(sx), np.asarray(sz), res)
    c2 = classify_batch_np(code.i_minus_p, np.asarray(xe), np.asarray(ze),
                           dx, dz, ec)
    print(f"BP+OSD(20)   @ p={p}: corrected {c2[3]}/{c2[0]}, "
          f"syndrome-fail {c2[4] + c2[5]}, logical {c2[6]}")

    # --- search for new instances at the same lattice shape ----------------
    hits = find_bicycle_codes(6, 6, count=2, min_k=8)
    print("BB(6,6) search, k>=8, girth>=6:",
          ", ".join(f"{h}" for h in hits))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
