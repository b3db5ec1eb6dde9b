"""Reference code-file loader.

File format (ref ``Quantum_LDPC_Code.h:26-80``), 4 whitespace lines:
  line 1: J K L P sigma tau
  line 2: dense pcmX, row-major, (J*P) x (L*P)
  line 3: dense pcmZ, row-major, (K*P) x (L*P)
  line 4: dense iMinusP, row-major, (2*L*P) x (2*L*P), block-diag "Hc 0 / 0 Hd"

Uses the native C++ fast parser when built (qec_ldpc.native), NumPy
otherwise.  The loaded dense matrices are kept verbatim for bit-parity tests;
the exponent tables are recovered from the circulant structure so the decoder
hot path is identical for file-loaded and constructed codes.
"""

from __future__ import annotations

import os

import numpy as np

from qec_ldpc.codes.css import QuantumLDPCCode, exponents_from_pcm


def _parse_all_ints(path: str) -> np.ndarray:
    """All whitespace-separated integers in the file, flat.  The native C++
    byte scanner handles the ~1.8M-field code610.txt in milliseconds; the
    fallback is a plain split."""
    from qec_ldpc import native

    size = max(64, os.path.getsize(path))  # ints are >= 2 bytes each incl. sep
    vals = native.parse_int_file(path, size)
    if vals is not None:
        return vals
    with open(path) as f:
        return np.array(f.read().split(), dtype=np.int64)


def load_code_file(path: str) -> QuantumLDPCCode:
    vals = _parse_all_ints(path)
    if vals.size < 6:
        raise ValueError(f"code file {path!r}: expected header J K L P sigma tau")
    J, K, L, P, sigma, tau = (int(x) for x in vals[:6])
    n = L * P
    need = 6 + (J + K) * P * n + 4 * n * n
    if vals.size < need:
        raise ValueError(
            f"code file {path!r}: expected {need} fields, got {vals.size}")
    off = 6
    pcm_x = vals[off:off + J * P * n].astype(np.int8).reshape(J * P, n)
    off += J * P * n
    pcm_z = vals[off:off + K * P * n].astype(np.int8).reshape(K * P, n)
    off += K * P * n
    imp = vals[off:off + 4 * n * n].astype(np.uint8).reshape(2 * n, 2 * n)
    hc = exponents_from_pcm(pcm_x, J, L, P)
    hd = exponents_from_pcm(pcm_z, K, L, P)
    return QuantumLDPCCode(
        J=J, K=K, L=L, P=P, sigma=sigma, tau=tau, hc=hc, hd=hd,
        _pcm_x=pcm_x, _pcm_z=pcm_z, _i_minus_p=imp,
    )


def save_code_file(code: QuantumLDPCCode, path: str) -> None:
    """Write a code in the reference 4-line format (round-trips via load_code_file)."""

    def fmt(m: np.ndarray) -> str:
        return " ".join(map(str, np.asarray(m, dtype=np.int64).ravel()))

    with open(path, "w") as f:
        f.write(f"{code.J} {code.K} {code.L} {code.P} {code.sigma} {code.tau}\n")
        f.write(fmt(code.pcm_x) + "\n")
        f.write(fmt(code.pcm_z) + "\n")
        f.write(fmt(code.i_minus_p) + "\n")
