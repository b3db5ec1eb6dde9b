"""Test oracle: an independent, straightforward NumPy implementation of the
reference decode semantics (DecoderCPU.h), written from the equations — used
to validate the vectorized batched decoder.  Deliberately naive and loop-heavy.

Semantics covered (ref file:line):
  - adjacency from dense PCM           (DecoderCPU.h:41-84)
  - message init to prior on edges     (DecoderCPU.h:135-148)
  - CN update 0.5*(1 -+ prod(1-2p))    (DecoderCPU.h:150-186)
  - VN update with last-iter posterior (DecoderCPU.h:188-229)
  - convergence band + every-10 check  (DecoderCPU.h:231-246, 280-291)
  - hard decision: any msg >= 0.5      (DecoderCPU.h:354-373)
  - error-code bitmask                 (Decoder.h:14-23, DecoderCPU.h:375-384)
"""

from __future__ import annotations

import numpy as np

SUCCESS = 0
SYNDROME_FAIL_X = 1
SYNDROME_FAIL_Z = 2
CONVERGENCE_FAIL_X = 4
CONVERGENCE_FAIL_Z = 8


def adjacency(pcm: np.ndarray):
    """eq->var and var->eq index lists from a dense PCM (rectangular degrees)."""
    num_eqs, num_vars = pcm.shape
    eq_vars = [np.nonzero(pcm[e])[0] for e in range(num_eqs)]
    var_eqs = [np.nonzero(pcm[:, v])[0] for v in range(num_vars)]
    return eq_vars, var_eqs


def bp_single(pcm, syndrome, error_probability, max_iters,
              low=0.01, high=0.99, check_every=10):
    """Run BP for a single syndrome.  Returns (var_msgs, eq_msgs) where
    var_msgs[v, e] is the var->check message (0 on non-edges), like the
    reference's varNodes array (numVars x numEqs)."""
    num_eqs, num_vars = pcm.shape
    eq_vars, var_eqs = adjacency(pcm)
    p = np.float32(2.0) / np.float32(3.0) * np.float32(error_probability)

    var_msgs = np.zeros((num_vars, num_eqs), dtype=np.float32)
    eq_msgs = np.zeros((num_eqs, num_vars), dtype=np.float32)
    for e in range(num_eqs):
        for v in eq_vars[e]:
            var_msgs[v, e] = p

    converged = False
    for n in range(max_iters):
        if converged:
            break
        # CN update
        for e in range(num_eqs):
            vs = eq_vars[e]
            for i, v in enumerate(vs):
                prod = np.float32(1.0)
                for k, v2 in enumerate(vs):
                    if k == i:
                        continue
                    prod *= np.float32(1.0) - np.float32(2.0) * var_msgs[v2, e]
                if syndrome[e]:
                    eq_msgs[e, v] = np.float32(0.5) * (np.float32(1.0) + prod)
                else:
                    eq_msgs[e, v] = np.float32(0.5) * (np.float32(1.0) - prod)
        # VN update
        last = n == max_iters - 1
        new_var = var_msgs.copy()
        for v in range(num_vars):
            es = var_eqs[v]
            for j, e in enumerate(es):
                prod_p = p
                prod_m = np.float32(1.0) - p
                for k, e2 in enumerate(es):
                    if j == k and not last:
                        continue
                    q = eq_msgs[e2, v]
                    prod_m *= np.float32(1.0) - q
                    prod_p *= q
                new_var[v, e] = prod_p / (prod_m + prod_p)
        var_msgs = new_var
        if n % check_every == 0:
            converged = check_convergence(var_msgs, low, high)
    return var_msgs, eq_msgs


def check_convergence(var_msgs, low=0.01, high=0.99) -> bool:
    nz = var_msgs[var_msgs != 0.0]
    return not np.any((nz > low) & (nz < high))


def decode(code, syndrome_x, syndrome_z, error_probability, max_iters):
    """Full Decode: returns (decisions_x, decisions_z, error_code_bitmask)."""
    vx, _ = bp_single(code.pcm_x % 2, syndrome_x, error_probability, max_iters)
    vz, _ = bp_single(code.pcm_z % 2, syndrome_z, error_probability, max_iters)
    dec_x = (vx >= 0.5).any(axis=1).astype(np.int64)
    dec_z = (vz >= 0.5).any(axis=1).astype(np.int64)
    rc = SUCCESS
    if not check_convergence(vx):
        rc |= CONVERGENCE_FAIL_X
    if not check_convergence(vz):
        rc |= CONVERGENCE_FAIL_Z
    if not np.array_equal(code.syndrome_x(dec_x) % 2, np.asarray(syndrome_x) % 2):
        rc |= SYNDROME_FAIL_X
    if not np.array_equal(code.syndrome_z(dec_z) % 2, np.asarray(syndrome_z) % 2):
        rc |= SYNDROME_FAIL_Z
    return dec_x, dec_z, rc
