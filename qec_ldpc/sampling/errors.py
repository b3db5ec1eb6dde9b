"""Random Pauli error generation — counter-based, lock-free, reproducible.

The reference draws weight-W errors from one shared mt19937 under an OpenMP
lock (``DecoderCPU.h:411,448-459``; standalone twin ``RandomErrorGenerator.h``):
W iid draws of (uniform qubit index, uniform type in {x=0, y=1, z=2}); x|y sets
the X bit, z|y sets the Z bit; repeated indices overwrite (never unset), so the
effective weight can be < W.

Here each batch lane derives its own ``jax.random`` key, so generation is
deterministic for a seed regardless of device count or batch partitioning —
the lock is replaced by counter-based PRNG.  Seeds do not transfer from the
C++ mt19937 stream; distributions match exactly (SURVEY §7 hard parts).

Error vectors are built by comparing the W drawn indices against a static
iota over variables — a vectorized (W, n, batch) reduction instead of a
scatter, which keeps everything dense and fusion-friendly.  Past a size
threshold that compare becomes a matrix product: factor each index into radix
digits ``idx = q*M + r`` and the membership test becomes a per-lane count
matmul ``C[r, q] = sum_w onehot_M(r)[w] * onehot_Q(q)[w]`` — ``hit = C > 0``.
The one-hots are exact 0/1 bf16 values accumulated in f32 (counts <= W <<
2^24, every product and sum exact — also under TF32 or bf16 matmul units), so
the result is BIT-identical to the direct compare while the O(W*n*batch) work
goes to the matrix units.  Same ``jax.random`` stream either way, so the
switch is safe for resume/golden parity.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

#: one-shot (W, n, batch) compare tensors beyond this many elements take the
#: count-matmul path (the flagship [[610]] workloads stay one-shot)
_ONESHOT_ELEMS = 1 << 24


def _accumulate_hits(idx: jnp.ndarray, typ: jnp.ndarray, n: int,
                     active: jnp.ndarray | None = None):
    """(x_errors, z_errors) int8 from draw arrays idx/typ (W, batch).

    ``active``: optional (W,) draw-enable mask (the dynamic sampler).
    Chooses the direct compare or the count-matmul by size; both compute
    the identical hit set, so results are bit-identical.
    """
    W, batch = idx.shape
    if W * n * batch <= _ONESHOT_ELEMS:
        var_ids = jnp.arange(n, dtype=idx.dtype)[None, :, None]    # (1, n, 1)
        hit = idx[:, None, :] == var_ids                   # (W, n, batch)
        if active is not None:
            hit = hit & active[:, None, None]
        xh = jnp.any(hit & (typ <= 1)[:, None, :], axis=0)
        zh = jnp.any(hit & (typ >= 1)[:, None, :], axis=0)
        return xh.astype(jnp.int8), zh.astype(jnp.int8)

    # ---- radix count-matmul path: idx = q*M + r; hit iff count(r, q) > 0 ----
    M = max(128, 1 << (int(np.ceil(np.sqrt(n))) - 1).bit_length())
    Q = -(-n // M)
    r = idx % M
    q = idx // M
    oh_r = r[:, None, :] == jnp.arange(M, dtype=idx.dtype)[None, :, None]
    oh_q = q[:, None, :] == jnp.arange(Q, dtype=idx.dtype)[None, :, None]
    if active is not None:
        oh_r = oh_r & active[:, None, None]
    a_x = (oh_r & (typ <= 1)[:, None, :]).astype(jnp.bfloat16)  # (W, M, batch)
    a_z = (oh_r & (typ >= 1)[:, None, :]).astype(jnp.bfloat16)
    b_q = oh_q.astype(jnp.bfloat16)                             # (W, Q, batch)
    dn = (((0,), (0,)), ((2,), (2,)))  # contract W; batch over lanes

    def dense(a):
        counts = jax.lax.dot_general(a, b_q, dn,
                                     preferred_element_type=jnp.float32)
        # (batch, M, Q) -> var-major (Q*M, batch), valid rows [:n]
        hits = (counts > 0).transpose(2, 1, 0).reshape(Q * M, batch)
        return hits[:n].astype(jnp.int8)

    return dense(a_x), dense(a_z)


@partial(jax.jit, static_argnames=("n", "weight", "batch"))
def sample_weight_w_errors(
    key: jax.Array, n: int, weight: int, batch: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Draw ``batch`` weight-``weight`` Pauli errors over ``n`` qubits.

    Returns (x_errors, z_errors), each (n, batch) int8 in {0,1}.
    """
    k_idx, k_typ = jax.random.split(key)
    idx = jax.random.randint(k_idx, (weight, batch), 0, n)          # qubit index
    typ = jax.random.randint(k_typ, (weight, batch), 0, 3)          # x=0,y=1,z=2
    return _accumulate_hits(idx, typ, n)


@partial(jax.jit, static_argnames=("n", "w_max", "batch"))
def sample_weight_w_errors_dynamic(
    key: jax.Array, n: int, weight: jax.Array, w_max: int, batch: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Weight-``weight`` errors with ``weight`` as a RUNTIME value.

    Same per-draw semantics as :func:`sample_weight_w_errors` (uniform
    index, uniform type, collisions overwrite), but ``w_max`` draws are made
    and only the first ``weight`` are active — so a whole weight sweep
    (W = 1..w_max) runs through ONE compiled program instead of one
    XLA program per weight (the reference recompiles nothing because it has
    no compiler; a 120-point sweep would otherwise compile 120 programs).
    For ``weight == w_max``
    the draws are bit-identical to the static sampler with the same key.
    """
    k_idx, k_typ = jax.random.split(key)
    idx = jax.random.randint(k_idx, (w_max, batch), 0, n)
    typ = jax.random.randint(k_typ, (w_max, batch), 0, 3)
    active = jnp.arange(w_max) < weight
    return _accumulate_hits(idx, typ, n, active)


@partial(jax.jit, static_argnames=("n", "batch"))
def sample_depolarizing_errors(
    key: jax.Array, n: int, p: float | jax.Array, batch: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """I.i.d. depolarizing channel: each qubit errs w.p. ``p``; error type
    uniform over {X, Y, Z}.  The framework-native error model for
    physical-error-rate sweeps (no reference analog; BASELINE config 3)."""
    k_err, k_typ = jax.random.split(key)
    err = jax.random.uniform(k_err, (n, batch)) < p
    typ = jax.random.randint(k_typ, (n, batch), 0, 3)
    x_errors = (err & (typ <= 1)).astype(jnp.int8)
    z_errors = (err & (typ >= 1)).astype(jnp.int8)
    return x_errors, z_errors
