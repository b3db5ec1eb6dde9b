"""Quasi-cyclic CSS code construction (Hagiwara–Imai, arXiv:quant-ph/0701020).

Builds the pair of exponent tables HC (J x L) and HD (K x L) over Z_P and
expands them into binary parity-check matrices made of P x P circulant
permutation blocks.  Behavioral reference: the (commented-out) constructor in
``QEC_LDPC_CSS.cu:26-131`` and the CUDA table builder ``kernels.cu:12-31``.

Design note: the *exponent tables are the code*.  Everything downstream
(syndrome extraction, BP message routing) operates directly on the tables via
cyclic rolls of P-sized lanes — the dense matrices exist only for file parity,
tests, and the GF(2) logical-operator algebra.
"""

from __future__ import annotations

import numpy as np


def _mod_pow(base: int, exp: int, p: int) -> int:
    """base**exp mod p, supporting negative exponents (base invertible mod p)."""
    if exp >= 0:
        return pow(base, exp, p)
    inv = pow(base, -1, p)  # raises ValueError if gcd(base, p) != 1
    return pow(inv, -exp, p)


def build_exponent_tables(
    J: int, K: int, L: int, P: int, sigma: int, tau: int
) -> tuple[np.ndarray, np.ndarray]:
    """Return (HC, HD) exponent tables, entries in [0, P).

    Formulas (ref ``QEC_LDPC_CSS.cu:43-90``):
      HC[j, l] = sigma^(l-j)                 mod P   for l <  L/2
               = P - tau * sigma^(j-1+l)     mod P   for l >= L/2
      HD[k, l] = tau * sigma^(l-k-1)         mod P   for l <  L/2
               = P - sigma^(k+l)             mod P   for l >= L/2

    The reference leaves ``P - x`` un-reduced (can equal P); circulant
    expansion is mod P so we normalize entries into [0, P) here.
    """
    if np.gcd(sigma, P) != 1:
        raise ValueError(f"sigma={sigma} is not invertible mod P={P}")
    half = L // 2
    hc = np.zeros((J, L), dtype=np.int64)
    hd = np.zeros((K, L), dtype=np.int64)
    for j in range(J):
        for l in range(L):
            if l < half:
                t = _mod_pow(sigma, l - j, P)
            else:
                t = (P - (tau * _mod_pow(sigma, j - 1 + l, P)) % P) % P
            hc[j, l] = t
    for k in range(K):
        for l in range(L):
            if l < half:
                t = (tau * _mod_pow(sigma, l - k - 1, P)) % P
            else:
                t = (P - _mod_pow(sigma, k + l, P)) % P
            hd[k, l] = t
    return hc, hd


def expand_circulant(table: np.ndarray, P: int) -> np.ndarray:
    """Expand an exponent table (B x L) into a dense binary PCM (B*P x L*P).

    Block (b, l) is the circulant permutation matrix I(1)^c with c = table[b,l]:
    row r of the block has its single 1 at column (c + r) % P
    (ref ``QEC_LDPC_CSS.cu:94-131``).
    """
    B, L = table.shape
    pcm = np.zeros((B * P, L * P), dtype=np.int8)
    r = np.arange(P)
    for b in range(B):
        for l in range(L):
            cols = (int(table[b, l]) + r) % P + l * P
            pcm[b * P + r, cols] = 1
    return pcm


def gf2_rref(m: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Reduced row-echelon form over GF(2).  Returns (rref_rows, pivot_cols).

    Only the nonzero rows are returned (shape rank x n).  Dispatches to the
    bit-packed native kernel (qec_ldpc/native, ~64x) when available; the
    NumPy path below is the behavioral reference.
    """
    from qec_ldpc import native

    res = native.gf2_rref(m)
    if res is not None:
        return res
    m = (np.asarray(m, dtype=np.uint8) % 2).copy()
    rows, cols = m.shape
    pivots: list[int] = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        nz = np.nonzero(m[r:, c])[0]
        if nz.size == 0:
            continue
        pivot = r + nz[0]
        if pivot != r:
            m[[r, pivot]] = m[[pivot, r]]
        hit = (m[:, c] == 1) & (np.arange(rows) != r)
        m[hit] ^= m[r]
        pivots.append(c)
        r += 1
    return m[:r], pivots


def gf2_annihilator(pcm: np.ndarray) -> np.ndarray:
    """The idempotent GF(2) matrix A with ker(A) = rowspace(pcm).

    This is the per-sector block of the reference's ``iMinusP`` logical-error
    test matrix (``Quantum_LDPC_Code.h:126-142``): a residual error vector e
    is *harmless* (pure stabilizer) iff A @ e == 0 mod 2.  Construction: with
    G the RREF basis of rowspace(pcm) and E the pivot-column selector
    (E @ G.T = I), A = I + G.T @ E mod 2.  Any A with this kernel yields an
    identical logical/corrected classification, so parity with the reference's
    file-shipped matrix is structural, not bit-wise.
    """
    g, pivots = gf2_rref(pcm)
    n = pcm.shape[1]
    a = np.eye(n, dtype=np.uint8)
    # A = I - G^T E: subtract (xor) outer structure g[i] into rows? Work
    # column-wise: (G^T E) has entry [v, w] = sum_i G[i, v] * E[i, w]
    # = G[row_of_pivot w, v] if w is pivot col i.
    for i, pc in enumerate(pivots):
        a[:, pc] ^= g[i]
    return a


def build_i_minus_p(pcm_x: np.ndarray, pcm_z: np.ndarray) -> np.ndarray:
    """Block-diagonal logical-test matrix diag(A_x, A_z) over the doubled space.

    Matches the structure of the file-shipped ``iMinusP``
    (``Quantum_LDPC_Code.h:67-74`` — "Hc 0 / 0 Hd" layout): verified
    empirically that the shipped matrix is block-diagonal, idempotent, with
    ker = rowspace of the respective PCM.
    """
    ax = gf2_annihilator(pcm_x)
    az = gf2_annihilator(pcm_z)
    n = pcm_x.shape[1]
    imp = np.zeros((2 * n, 2 * n), dtype=np.uint8)
    imp[:n, :n] = ax
    imp[n:, n:] = az
    return imp


def multiplicative_order(a: int, p: int) -> int | None:
    """Multiplicative order of ``a`` in Z_p*, or None if gcd(a, p) != 1."""
    if np.gcd(a, p) != 1:
        return None
    x, order = a % p, 1
    while x != 1:
        x = x * a % p
        order += 1
    return order


def check_css_orthogonal(hc: np.ndarray, hd: np.ndarray, P: int) -> bool:
    """CSS condition HC_bin @ HD_bin^T == 0 (mod 2), checked on the exponent
    tables directly: circulant block (j, k) of the product is
    sum_l x^(hc[j,l] - hd[k,l]) mod (x^P - 1) over GF(2), which vanishes iff
    every difference value occurs an even number of times.  O(J*K*L) instead
    of a dense (J*P x L*P) @ (L*P x K*P) product."""
    hc = np.asarray(hc) % P
    hd = np.asarray(hd) % P
    for j in range(hc.shape[0]):
        for k in range(hd.shape[0]):
            _, counts = np.unique((hc[j] - hd[k]) % P, return_counts=True)
            if (counts % 2).any():
                return False
    return True


def find_code_params(J: int, K: int, L: int, P: int,
                     count: int = 1,
                     require_girth6: bool = False) -> list[tuple[int, int]]:
    """Search (sigma, tau) producing a valid CSS code for (J, K, L, P).

    The Hagiwara–Imai construction is CSS-orthogonal exactly when sigma has
    multiplicative order L/2 in Z_P* (verified empirically: both reference
    codes satisfy it — ord(2 mod 7) = 3 = 6/2, ord(9 mod 61) = 5 = 10/2 — and
    an exhaustive P=61 scan found orthogonality for all tau and only those
    sigma).  This searches sigma of order L/2 and filters each (sigma, tau)
    through :func:`check_css_orthogonal`, enabling construction of larger
    lifted codes (e.g. ``find_code_params(4, 5, 10, 131)`` -> (53, 1)) for
    scaling studies.  ``require_girth6`` additionally rejects candidates
    whose X or Z Tanner graph has 4-cycles (the cheap exponent-table test of
    codes/analysis.py — BP quality degrades visibly on girth-4 graphs; the
    reference claims girth >= 6 for its construction, QEC_LDPC_CSS.cu:
    161-164, and both shipped codes satisfy it).  Returns up to ``count``
    (sigma, tau) pairs in ascending order; raises if L is odd or no
    generator of order L/2 exists mod P.
    """
    if L % 2 != 0:
        raise ValueError(f"L={L} must be even (construction splits at L/2)")
    half = L // 2
    sigmas = [s for s in range(2, P)
              if multiplicative_order(s, P) == half]
    if not sigmas:
        raise ValueError(
            f"no element of multiplicative order L/2={half} exists mod P={P} "
            f"(need L/2 to divide P-1 for prime P)")
    found: list[tuple[int, int]] = []
    for s in sigmas:
        for t in range(1, P):
            hc, hd = build_exponent_tables(J, K, L, P, s, t)
            if not check_css_orthogonal(hc, hd, P):
                continue
            if require_girth6:
                from qec_ldpc.codes.analysis import qc_has_4cycles

                if qc_has_4cycles(hc, P) or qc_has_4cycles(hd, P):
                    continue
            found.append((s, t))
            if len(found) >= count:
                return found
    return found
