"""ctypes bindings for the native GF(2) kernel library (gf2.cpp).

Builds ``_gf2-<tag>.so`` with g++ on first use (cached beside the source,
keyed on the source and the host, ignored by git); every
entry point has a NumPy fallback so the framework works without a compiler.
``HAVE_NATIVE`` reports which path is active.

Bit packing convention: row-major, little-endian bit order within 64-bit
words (numpy ``packbits(bitorder="little")`` viewed as uint64).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gf2.cpp")


def _build_tag() -> str:
    """Short hash of gf2.cpp and this host's ISA surface.

    The library is built with ``-march=native``, so a cached ``.so`` carried
    to a host lacking the build host's ISA extensions (NFS home, baked
    container image) would load fine via CDLL but SIGILL at call time — which
    cannot be caught in-process.  Keying the cache file on (machine, cpuinfo
    flags) makes a foreign-host cache a miss, not a crash; keying it on the
    source makes an edited gf2.cpp a miss, not a stale library.
    """
    with open(_SRC, "rb") as f:
        ident = hashlib.sha256(f.read()).hexdigest()
    ident += "|" + platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("flags", "features")):
                    ident += "|" + line.split(":", 1)[-1].strip()
                    break
    except OSError:
        ident += "|" + platform.processor()
    return hashlib.sha256(ident.encode()).hexdigest()[:12]


_SO = os.path.join(_DIR, f"_gf2-{_build_tag()}.so")

_lock = threading.Lock()
_lib = None
_tried = False
HAVE_NATIVE = False


def _build() -> bool:
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", _SO, _SRC]
    # -march=native lets the word-wide GF(2) XOR/popcount loops vectorize to
    # the host's SIMD width (AVX2: 4x u64 per op — measured ~1.5x on the OSD
    # solver); OpenMP parallelizes over lanes.  Fall back gracefully where
    # either is unavailable (everything stays correct)
    for cmd in (base[:1] + ["-fopenmp", "-march=native"] + base[1:],
                base[:1] + ["-fopenmp"] + base[1:], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            return True
        except (OSError, subprocess.SubprocessError):
            continue
    return False


def _load():
    global _lib, HAVE_NATIVE, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            if not _build():
                HAVE_NATIVE = False
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            HAVE_NATIVE = False
            return None
        lib.qec_gf2_rref.restype = ctypes.c_int
        lib.qec_gf2_rref.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.qec_gf2_matvec.restype = None
        lib.qec_gf2_matvec.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.qec_parse_ints.restype = ctypes.c_long
        lib.qec_parse_ints.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long]
        lib.qec_osd_batch.restype = ctypes.c_int
        lib.qec_osd_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        HAVE_NATIVE = True
        return _lib


def pack_rows(m: np.ndarray) -> tuple[np.ndarray, int]:
    """(rows, cols) 0/1 matrix -> (rows, words) uint64 packed, plus words."""
    m = np.ascontiguousarray(np.asarray(m, dtype=np.uint8) % 2)
    rows, cols = m.shape
    words = max(1, -(-cols // 64))
    packed_bytes = np.packbits(m, axis=1, bitorder="little")
    pad = words * 8 - packed_bytes.shape[1]
    if pad:
        packed_bytes = np.pad(packed_bytes, ((0, 0), (0, pad)))
    return np.ascontiguousarray(packed_bytes).view(np.uint64).reshape(rows, words), words


def unpack_rows(packed: np.ndarray, cols: int) -> np.ndarray:
    """(rows, words) uint64 -> (rows, cols) uint8 0/1 matrix."""
    rows = packed.shape[0]
    if rows == 0:
        return np.zeros((0, cols), dtype=np.uint8)
    as_bytes = np.ascontiguousarray(packed).view(np.uint8).reshape(rows, -1)
    bits = np.unpackbits(as_bytes, axis=1, bitorder="little")
    return bits[:, :cols]


def gf2_rref(m: np.ndarray) -> tuple[np.ndarray, list[int]] | None:
    """Native RREF over GF(2): returns (rref nonzero rows, pivot cols), or
    None when the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    m = np.asarray(m, dtype=np.uint8)
    rows, cols = m.shape
    if rows == 0 or cols == 0:
        return m.copy(), []
    packed, words = pack_rows(m)
    pivots = np.zeros(min(rows, cols), dtype=np.int32)
    rank = lib.qec_gf2_rref(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rows, words, cols,
        pivots.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return unpack_rows(packed[:rank], cols), [int(p) for p in pivots[:rank]]


def gf2_matvec(m: np.ndarray, vecs: np.ndarray) -> np.ndarray | None:
    """Batched mod-2 matvec: (rows, cols) x (batch, cols) -> (rows, batch)
    uint8, or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    pm, words = pack_rows(m)
    pv, words_v = pack_rows(vecs)
    assert words == words_v, (m.shape, vecs.shape)
    rows, batch = pm.shape[0], pv.shape[0]
    out = np.zeros((rows, batch), dtype=np.uint8)
    lib.qec_gf2_matvec(
        pm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), rows, words,
        pv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), batch,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def parse_int_file(path: str, max_count: int) -> np.ndarray | None:
    """Parse whitespace-separated integers; None without the native library."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(max_count, dtype=np.int64)
    got = lib.qec_parse_ints(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        max_count)
    if got < 0:
        raise FileNotFoundError(path)
    return out[:got]


def osd_batch(
    packed_cols: np.ndarray,   # (n, w) uint64 packed columns of H (m rows)
    m: int,
    order: np.ndarray,         # (batch, n) int32, most-likely-error first
    packed_syn: np.ndarray,    # (batch, w) uint64 packed syndromes
    lam: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native batched OSD solve: returns ((batch, n) uint8 corrections,
    (batch,) bool solved), or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    n, w = packed_cols.shape
    batch = packed_syn.shape[0]
    packed_cols = np.ascontiguousarray(packed_cols, dtype=np.uint64)
    order = np.ascontiguousarray(order, dtype=np.int32)
    packed_syn = np.ascontiguousarray(packed_syn, dtype=np.uint64)
    assert order.shape == (batch, n), (order.shape, batch, n)
    e_out = np.zeros((batch, n), dtype=np.uint8)
    status = np.zeros(batch, dtype=np.uint8)
    lib.qec_osd_batch(
        packed_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        m, n, w,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        packed_syn.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        batch, lam,
        e_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return e_out, status == 0


def native_available() -> bool:
    return _load() is not None
