"""Per-sample outcome classification and counter reduction.

Reproduces the classification lattice of the reference Monte-Carlo harness
(``DecoderCPU.h:480-521``, SURVEY §3.4) exactly:

  1. syndrome-fail X / Z counters increment independently;
  2. only if *neither* syndrome failed, the residual (e + e_hat mod 2) in the
     doubled [x; z] space is tested for a logical component
     (``Quantum_LDPC_Code.h:126-142``) -> logicalErrors, else corrected;
  3. convergence-fail X / Z counters increment orthogonally ("it can fail to
     converge and still potentially produce a correct output").

Counters are returned as a single int32 vector so multi-chip aggregation is a
plain ``psum`` (replacing ``#pragma omp atomic``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from qec_ldpc.decoder.decode import (
    CONVERGENCE_FAIL_X,
    CONVERGENCE_FAIL_Z,
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
)

# Counter vector layout (see harness/stats.py for the record mapping)
NUM_COUNTERS = 9
(C_TESTED, C_X_TESTED, C_Z_TESTED, C_CORRECTED, C_SYN_X, C_SYN_Z,
 C_LOGICAL, C_CONV_X, C_CONV_Z) = range(NUM_COUNTERS)


class RankBasisTest(NamedTuple):
    """Rank-basis logical-error test: the scalable form of ``iMinusP``.

    The dense test (``Quantum_LDPC_Code.h:126-142``) multiplies the residual
    by a (2n x 2n) annihilator ``A = I + G^T E`` (codes/construction.py
    ``gf2_annihilator``) — O(4n^2) memory, the same scaling wall as the
    reference's dense matrices.  This carries only the RREF basis ``G``
    (rank x n) and its pivot columns per sector: the residual ``r`` lies in
    rowspace(pcm) iff ``r == G^T r[pivots] (mod 2)``, i.e. ``A @ r == 0``
    expanded — bit-identical classification (any matrix with the same kernel
    classifies identically) at O(rank * n) memory, so P >= 499 codes
    classify on one chip.  Build with :func:`rank_basis_test` /
    :func:`make_rank_basis_test`; every classify entry point accepts this in
    place of the dense ``i_minus_p`` array.
    """

    basis_x: jnp.ndarray   # (rank_x, n) RREF rows of the x-sector rowspace
    pivots_x: jnp.ndarray  # (rank_x,) int32 pivot columns (E selector)
    basis_z: jnp.ndarray   # (rank_z, n)
    pivots_z: jnp.ndarray  # (rank_z,)


def rank_basis_test(space_for_x, space_for_z) -> RankBasisTest:
    """Build a :class:`RankBasisTest` from the two GF(2) matrices whose
    rowspaces define "harmless" residuals (x sector, z sector)."""
    from qec_ldpc.codes.construction import gf2_rref

    gx, px = gf2_rref(np.asarray(space_for_x))
    gz, pz = gf2_rref(np.asarray(space_for_z))
    return RankBasisTest(
        basis_x=jnp.asarray(gx, jnp.int8),
        pivots_x=jnp.asarray(px, jnp.int32),
        basis_z=jnp.asarray(gz, jnp.int8),
        pivots_z=jnp.asarray(pz, jnp.int32),
    )


def make_rank_basis_test(code, logical_test: str = "reference") -> RankBasisTest:
    """Rank-basis test equivalent to ``code.i_minus_p`` (or the physical
    variant) for any supported code family.

    * QC-CSS codes (codes/css.py): ``"reference"`` reproduces the shipped
      ``iMinusP`` semantics (x residual harmless iff in rowspace(pcm_x) —
      the DETECTING matrix); ``"physical"`` uses the CSS-correct opposite
      sectors (rowspace of the same-Pauli-type stabilizers).
    * BB / HGP codes (codes/{bicycle,hypergraph}.py) are physical-convention
      already (sectors hx_stab / hz_stab) under either name.
    """
    if logical_test not in ("reference", "physical"):
        raise ValueError(f"unknown logical_test {logical_test!r}")
    if hasattr(code, "hx_stab"):  # lifted families: one convention
        return rank_basis_test(code.hx_stab, code.hz_stab)
    if logical_test == "physical":
        return rank_basis_test(code.pcm_z, code.pcm_x)
    return rank_basis_test(code.pcm_x, code.pcm_z)


def _sector_logical(basis: jnp.ndarray, pivots: jnp.ndarray,
                    r: jnp.ndarray) -> jnp.ndarray:
    """(n, batch) residual -> (batch,) bool: r not in rowspace(basis).

    ``A @ r`` of the dense test expanded: ``r + G^T r[pivots] (mod 2)`` is
    nonzero iff r is outside the rowspace.  The gather is static (pivot
    indices), the matmul is (n x rank) @ (rank x batch) of 0/1 operands into
    an f32 accumulator — exact for rank < 2^23, also when the matrix units
    round f32 operands to TF32 or bf16 (0 and 1 are exact in both)."""
    coeff = r[pivots].astype(jnp.float32)                     # (rank, batch)
    recon = jnp.dot(basis.T.astype(jnp.float32), coeff,
                    preferred_element_type=jnp.float32)       # (n, batch)
    diff = jnp.mod(recon + r.astype(jnp.float32), 2.0)
    return jnp.any(diff > 0.5, axis=0)


def logical_error_mask_basis(test: RankBasisTest,
                             residual_2n: jnp.ndarray) -> jnp.ndarray:
    """(2n, batch) residual -> (batch,) bool logical mask, rank-basis form."""
    n = test.basis_x.shape[1]
    return (_sector_logical(test.basis_x, test.pivots_x, residual_2n[:n])
            | _sector_logical(test.basis_z, test.pivots_z, residual_2n[n:]))


def logical_error_mask(i_minus_p: jnp.ndarray, residual_2n: jnp.ndarray) -> jnp.ndarray:
    """(2n, batch) residual -> (batch,) bool: any row of iMinusP @ e odd.

    Dense GF(2) matvec done as an f32 matmul of 0/1 operands (exact for
    n < 2^23, also under TF32 or bf16 operand rounding) followed by a parity
    test — the batched shape of ``Quantum_LDPC_Code.h:131-141``.
    """
    m = i_minus_p.astype(jnp.float32)
    prod = jnp.dot(m, residual_2n.astype(jnp.float32),
                   preferred_element_type=jnp.float32)
    odd = jnp.mod(prod, 2.0) > 0.5
    return jnp.any(odd, axis=0)


def classify_batch_np(
    i_minus_p,
    x_errors,
    z_errors,
    x_decoded,
    z_decoded,
    error_code,
):
    """Host (NumPy) mirror of :func:`classify_batch` — identical counters.

    Used by post-processing paths (OSD, decoder/osd.py) that splice
    corrections on the host after the device decode; the logical test runs
    through the native packed GF(2) matvec when available.
    """
    import numpy as np

    from qec_ldpc import native

    x_errors = np.asarray(x_errors)
    z_errors = np.asarray(z_errors)
    error_code = np.asarray(error_code)
    batch = error_code.shape[0]
    x_tested = (x_errors != 0).any(axis=0)
    z_tested = (z_errors != 0).any(axis=0)
    syn_x = (error_code & SYNDROME_FAIL_X) != 0
    syn_z = (error_code & SYNDROME_FAIL_Z) != 0
    conv_x = (error_code & CONVERGENCE_FAIL_X) != 0
    conv_z = (error_code & CONVERGENCE_FAIL_Z) != 0
    undetected = ~(syn_x | syn_z)
    residual = np.concatenate(
        [(x_errors + np.asarray(x_decoded)) % 2,
         (z_errors + np.asarray(z_decoded)) % 2], axis=0).astype(np.uint8)
    if isinstance(i_minus_p, RankBasisTest):
        n = i_minus_p.basis_x.shape[1]

        def sector(basis, pivots, r):
            basis = np.asarray(basis)
            coeff = r[np.asarray(pivots)]          # (rank, batch) 0/1
            if basis.shape[0] == 0:
                return r.astype(bool).any(axis=0)
            # packed-XOR reconstruction (native/gf2.cpp): ~rank/64 word-ops
            # per output bit vs an int64 matmul — the failed-lane classify
            # of the fast quality mode runs on the host, so this is on the
            # quality throughput path at heavy weights
            recon = native.gf2_matvec(basis.T, coeff.T)
            if recon is None:
                recon = ((basis.T.astype(np.int64)
                          @ coeff.astype(np.int64)) % 2).astype(np.uint8)
            return ((recon ^ r) != 0).any(axis=0)

        logical = (sector(i_minus_p.basis_x, i_minus_p.pivots_x, residual[:n])
                   | sector(i_minus_p.basis_z, i_minus_p.pivots_z,
                            residual[n:]))
    else:
        prod = native.gf2_matvec(np.asarray(i_minus_p), residual.T)
        if prod is None:
            prod = (np.asarray(i_minus_p).astype(np.int64)
                    @ residual.astype(np.int64)) % 2
        logical = prod.astype(bool).any(axis=0)
    logical_cnt = undetected & logical
    corrected_cnt = undetected & ~logical
    return np.array([
        batch, x_tested.sum(), z_tested.sum(), corrected_cnt.sum(),
        syn_x.sum(), syn_z.sum(), logical_cnt.sum(), conv_x.sum(),
        conv_z.sum(),
    ], dtype=np.int64)


def classify_batch(
    i_minus_p: jnp.ndarray,
    x_errors: jnp.ndarray,      # (n, batch) true errors
    z_errors: jnp.ndarray,
    x_decoded: jnp.ndarray,     # (n, batch) hard decisions
    z_decoded: jnp.ndarray,
    error_code: jnp.ndarray,    # (batch,) bitmask from decode_batch
    valid: jnp.ndarray | None = None,  # (batch,) bool lane mask
) -> jnp.ndarray:
    """Returns int32 counter vector of length NUM_COUNTERS (summed over batch).

    ``valid``: lanes where it is False are excluded from EVERY counter
    (including tested counts) — used by the fast quality mode to classify
    the non-failed lanes on device while the failed lanes detour through
    host repair (parallel/montecarlo.py); the two partial counter vectors
    sum to exactly the full-batch classification.
    """
    batch = error_code.shape[0]
    x_tested = jnp.any(x_errors != 0, axis=0)
    z_tested = jnp.any(z_errors != 0, axis=0)

    syn_x = (error_code & SYNDROME_FAIL_X) != 0
    syn_z = (error_code & SYNDROME_FAIL_Z) != 0
    conv_x = (error_code & CONVERGENCE_FAIL_X) != 0
    conv_z = (error_code & CONVERGENCE_FAIL_Z) != 0

    undetected = ~(syn_x | syn_z)
    residual = jnp.concatenate(
        [(x_errors + x_decoded) % 2, (z_errors + z_decoded) % 2], axis=0
    )
    if isinstance(i_minus_p, RankBasisTest):
        logical = logical_error_mask_basis(i_minus_p, residual)
    else:
        logical = logical_error_mask(i_minus_p, residual)
    logical_cnt = undetected & logical
    corrected_cnt = undetected & ~logical

    if valid is None:
        tested = jnp.int32(batch)

        def s(mask):
            return jnp.sum(mask, dtype=jnp.int32)
    else:
        tested = jnp.sum(valid, dtype=jnp.int32)

        def s(mask):
            return jnp.sum(mask & valid, dtype=jnp.int32)

    return jnp.stack([
        tested, s(x_tested), s(z_tested), s(corrected_cnt),
        s(syn_x), s(syn_z), s(logical_cnt), s(conv_x), s(conv_z),
    ])
