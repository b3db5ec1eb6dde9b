"""Tanner-graph girth analysis (codes/analysis.py): verifies the reference's
girth >= 6 construction claim (QEC_LDPC_CSS.cu:161-164) and cross-checks the
BFS girth against the QC exponent-table 4-cycle condition."""

import numpy as np
import pytest

import qec_ldpc as q
from qec_ldpc.codes.analysis import girth_report, qc_has_4cycles, tanner_girth


def test_girth_known_small_graphs():
    # 4-cycle: two checks sharing two vars
    pcm4 = np.array([[1, 1, 0], [1, 1, 0]])
    assert tanner_girth(pcm4) == 4
    # 6-cycle: 3 checks, 3 vars, ring
    pcm6 = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]])
    assert tanner_girth(pcm6) == 6
    # 8-cycle ring over 4 checks / 4 vars
    pcm8 = np.zeros((4, 4), dtype=int)
    for i in range(4):
        pcm8[i, i] = pcm8[i, (i + 1) % 4] = 1
    assert tanner_girth(pcm8) == 8
    # tree (no cycle)
    tree = np.array([[1, 1, 0], [0, 0, 1]])
    assert tanner_girth(tree) == 0


def test_qc_4cycle_condition_matches_bfs():
    from qec_ldpc.codes.construction import expand_circulant

    rng = np.random.default_rng(0)
    found = {True: 0, False: 0}
    for _ in range(20):
        P = int(rng.integers(3, 12))
        B, L = 2, int(rng.integers(2, 5))
        table = rng.integers(0, P, size=(B, L))
        pcm = expand_circulant(table, P)
        has4 = qc_has_4cycles(table, P)
        assert has4 == (tanner_girth(pcm, cap=4) == 4)
        found[has4] += 1
    assert found[True] and found[False], "want both outcomes exercised"


def test_find_code_params_girth_filter():
    from qec_ldpc.codes.construction import find_code_params

    pairs = find_code_params(4, 5, 10, 61, count=3, require_girth6=True)
    assert pairs, "girth-6 candidates must exist for the reference params"
    for s, t in pairs:
        code = q.construct_code(4, 5, 10, 61, s, t)
        assert not qc_has_4cycles(code.hc, 61)
        assert not qc_has_4cycles(code.hd, 61)


@pytest.mark.parametrize("params", [(3, 3, 6, 7, 2, 3), (4, 5, 10, 61, 9, 49)])
def test_reference_codes_have_girth_6(params):
    """The reference's construction claim, verified on both shipped codes:
    girth exactly 6 (no 4-cycles; 6-cycles exist)."""
    code = q.construct_code(*params)
    rep = girth_report(code)
    assert rep["reference_claim_girth_ge_6"]
    assert rep["girth_x"] == 6 and rep["girth_z"] == 6
    assert not rep["qc_4cycles_x"] and not rep["qc_4cycles_z"]
