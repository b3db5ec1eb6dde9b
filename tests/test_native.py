"""Native C++ GF(2) kernels (qec_ldpc/native) vs the NumPy references."""

import numpy as np
import pytest

from qec_ldpc import native
from qec_ldpc.codes import construction


@pytest.fixture(scope="module")
def have_native():
    if not native.native_available():
        pytest.skip("native library unavailable (no g++?)")


def _numpy_rref(m):
    """The pure-NumPy RREF (construction.py fallback), inlined so the test
    compares implementations rather than the dispatching wrapper."""
    m = (np.asarray(m, dtype=np.uint8) % 2).copy()
    rows, cols = m.shape
    pivots, r = [], 0
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


@pytest.mark.parametrize("rows,cols", [(1, 1), (7, 5), (30, 64), (65, 130), (40, 200)])
def test_rref_matches_numpy(have_native, rng, rows, cols):
    for _ in range(3):
        m = rng.integers(0, 2, (rows, cols), dtype=np.uint8)
        got = native.gf2_rref(m)
        assert got is not None
        g_rows, g_piv = got
        e_rows, e_piv = _numpy_rref(m)
        assert g_piv == e_piv
        assert np.array_equal(g_rows, e_rows)


def test_rref_idempotent_annihilator(have_native, small_code):
    """construction.gf2_annihilator through the native RREF keeps its
    defining properties: idempotent with kernel = rowspace(pcm)."""
    a = construction.gf2_annihilator(small_code.pcm_x)
    assert np.array_equal((a @ a) % 2, a % 2)
    assert not ((small_code.pcm_x @ a.T) % 2).any()


def test_matvec_matches_numpy(have_native, rng):
    m = rng.integers(0, 2, (37, 130), dtype=np.uint8)
    v = rng.integers(0, 2, (9, 130), dtype=np.uint8)
    got = native.gf2_matvec(m, v)
    assert got is not None
    expect = (v.astype(np.int64) @ m.T.astype(np.int64)).T % 2
    assert np.array_equal(got, expect.astype(np.uint8))


def test_parse_int_file(have_native, tmp_path):
    p = tmp_path / "ints.txt"
    p.write_text("3 3 6 7 2 3\n0 1 0\n  42\t7\n")
    vals = native.parse_int_file(str(p), 64)
    assert vals is not None
    assert vals.tolist() == [3, 3, 6, 7, 2, 3, 0, 1, 0, 42, 7]


def test_pack_unpack_roundtrip(rng):
    m = rng.integers(0, 2, (11, 77), dtype=np.uint8)
    packed, words = native.pack_rows(m)
    assert words == 2
    assert np.array_equal(native.unpack_rows(packed, 77), m)
