"""Statistical parity vs the reference's golden Monte-Carlo corpus.

The reference ships ~280 result files (QEC_LDPC/results/**) that are its
de-facto regression suite (SURVEY §4).  RNG streams don't transfer from the
C++ locked mt19937 (SURVEY §7 hard parts), so parity is statistical: outcome
fractions must agree within Monte-Carlo tolerance.  Golden numbers below are
from results/[2,3,6,7,2,3]/ at 100k samples, MAX=100, p=0.02; the three
shipped repeat runs at W=3 vary by ±0.35% absolute, and our 10k-sample runs
have binomial sigma <= 0.5%, so a ±2% absolute gate is ~4 combined sigma —
tight enough to catch any semantic drift in decode/classification, loose
enough to never flake.
"""

import numpy as np
import pytest

from qec_ldpc.decoder import BPConfig
from qec_ldpc.parallel import make_mesh, run_monte_carlo
from qec_ldpc.sampling import (
    C_CORRECTED, C_LOGICAL, C_SYN_X, C_SYN_Z, C_TESTED,
)

# golden fractions: weight -> (corrected, logical, syndrome_x, syndrome_z)
# from results/[2,3,6,7,2,3]/..._W_{w}_MAX_100_p_0.02.txt (100k samples each)
GOLDEN = {
    1: (1.00000, 0.00000, 0.00000, 0.00000),
    2: (0.75887, 0.00000, 0.12957, 0.12760),
    3: (0.50962, 0.14348, 0.19367, 0.18974),
    4: (0.27761, 0.29310, 0.24690, 0.24065),
}

COUNT = 10_000
TOL = 0.02


@pytest.mark.parametrize("weight", sorted(GOLDEN))
def test_outcome_fractions_match_golden_corpus(small_graphs, weight):
    mesh = make_mesh()  # 8 virtual CPU devices, data-parallel
    counters, _ = run_monte_carlo(
        small_graphs, weight, COUNT, 0.02, BPConfig(max_iters=100),
        seed=1000 + weight, batch_size=1024, mesh=mesh)
    tested = counters[C_TESTED]
    assert tested >= COUNT
    got = (
        counters[C_CORRECTED] / tested,
        counters[C_LOGICAL] / tested,
        counters[C_SYN_X] / tested,
        counters[C_SYN_Z] / tested,
    )
    want = GOLDEN[weight]
    for name, g, w in zip(("corrected", "logical", "syn_x", "syn_z"), got, want):
        assert abs(g - w) <= TOL, (
            f"W={weight} {name}: got {g:.4f}, golden {w:.4f} (tol {TOL})")


# ---------------------------------------------------------------------------
# [[610,61]] flagship-code parity (corpus provenance: the reference's [[610]]
# results match only at prior p=0.02 — both its p_0.01- and p_0.02-labeled
# files carry statistically identical fractions, so those runs were generated
# with p=0.02 regardless of label.  See benchmarks/ler_sweep.py docstring.
# Golden numbers from results/[4,5,10,61,9,49]/..._W_{w}_MAX_100_p_0.01.txt
# (10k samples each).
# ---------------------------------------------------------------------------

GOLDEN_610 = {  # weight -> (corrected, syndrome_x + syndrome_z)
    20: (0.9912, 0.0088),
    30: (0.9452, 0.0547),
}
COUNT_610 = 2048


@pytest.fixture(scope="session")
def graphs610(code610):
    from qec_ldpc.decoder import CodeGraphs

    return CodeGraphs.build(code610)


@pytest.mark.parametrize("weight", sorted(GOLDEN_610))
def test_610_outcome_fractions_match_golden_corpus(graphs610, weight):
    counters, _ = run_monte_carlo(
        graphs610, weight, COUNT_610, 0.02, BPConfig(max_iters=100),
        seed=6100 + weight, batch_size=COUNT_610)
    tested = counters[C_TESTED]
    assert tested >= COUNT_610
    corrected = counters[C_CORRECTED] / tested
    syn = (counters[C_SYN_X] + counters[C_SYN_Z]) / tested
    want_c, want_s = GOLDEN_610[weight]
    # 2048 samples: binomial sigma <= 0.5%; 2% gate = >= 4 sigma
    assert abs(corrected - want_c) <= 0.02, (weight, corrected, want_c)
    assert abs(syn - want_s) <= 0.02, (weight, syn, want_s)


def test_full_610_weight_sweep_artifact():
    """VERDICT r2 #5: the committed full-corpus sweep artifact
    (benchmarks/data/golden_sweep_r3.jsonl, generated by
    benchmarks/golden_sweep.py) pins plain sum-product BP against EVERY
    [[610,61]] golden file (122 points: W=1..60, both labeled p values).

    Gate: the provenance-corrected z-score (decoded at prior 0.02 for the
    p_0.01-labeled files, which the reference evidently generated at 0.02 —
    the round-2 corpus finding) stays within 4.5 sigma everywhere and its
    median is sub-sigma.  The artifact's own uncorrected z for p_0.01 labels
    documents the mislabeling (systematically negative in the threshold
    region) and is intentionally not gated.
    """
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "data", "golden_sweep_r3.jsonl")
    lines = [json.loads(ln) for ln in open(path) if ln.strip()]
    meta, recs = lines[0], lines[1:]
    assert meta["decoder"] == "sum-product"
    assert len(recs) >= 120
    weights = {(r["weight"], r["p"]) for r in recs}
    assert all((w, 0.01) in weights and (w, 0.02) in weights
               for w in range(1, 59))
    zs = []
    for r in recs:
        z = r.get("z_score_prior002", r["z_score"])
        zs.append(abs(z))
        assert abs(z) < 4.5, (r["weight"], r["p"], z)
        # every point carries both sides' raw counts for re-derivation
        assert r["ref_tested"] >= 100 and r["ours_tested"] >= r["ref_tested"]
    assert float(np.median(zs)) < 1.5
    # physical sanity: our corrected fraction decreases with weight (0.01
    # label set, which spans the full 1..60 range at 10k reference samples)
    curve = sorted((r["weight"], r["ours_corrected_fraction"])
                   for r in recs if r["p"] == 0.01)
    fracs = [f for _, f in curve]
    # allow small non-monotonic noise between adjacent weights
    assert all(fracs[i + 3] <= fracs[i] + 0.02
               for i in range(len(fracs) - 3))
