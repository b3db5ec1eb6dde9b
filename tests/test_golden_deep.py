"""Deep-statistics count parity gate (VERDICT r3 #1).

Pins the committed ``benchmarks/data/golden_deep_r4.jsonl`` artifact —
>= 1M decoded samples per corpus weight — against the
reference's deepest [[610,61]] golden files.  This is the unproven half of
the north-star's "logical-error parity" clause: not fractions, COUNTS of the
rare events (logical errors, convergence failures per ``DecoderCPU.h:
514-521``, syndrome failures), compared by exact conditional binomial
two-sample tests.

Provenance rule (measured IN the artifact, see its meta note): the W>=20
subdir corpus files were generated at prior 0.02 (round-2 finding), while
the 100 000-sample W=15 headline file
(``results/[J=4,...][[n=610,k=61]]_W_15_MAX_100_p_0.01.txt``) was generated
at its labeled prior 0.01 — each point gates at its own generation prior.
"""

import json
import os

import pytest

ARTIFACT = os.path.join(os.path.dirname(__file__), os.pardir,
                        "benchmarks", "data", "golden_deep_r4.jsonl")

COUNTERS = ("logical", "syn_x", "syn_z", "conv_x", "conv_z")


@pytest.fixture(scope="module")
def artifact():
    with open(ARTIFACT) as f:
        recs = [json.loads(line) for line in f]
    return recs[0], {r["weight"]: r for r in recs[1:]}


def _tag(weight: int) -> str:
    """Per-point generation-prior field suffix (see module docstring)."""
    return "_prior001" if weight == 15 else ""


def test_artifact_depth_and_coverage(artifact):
    meta, points = artifact
    assert meta["samples_per_point"] >= 1_000_000
    assert meta["decoder"] == "sum-product"
    # the VERDICT-named weights, including the conv-fail curve's anchor
    # points W=30 (ref 4) and W=58 (ref 8632)
    assert set(points) == {15, 20, 25, 30, 40, 50, 58}
    for w, rec in points.items():
        assert rec[f"ours_tested{_tag(w)}"] >= 1_000_000
    # W=15 compares against the 100k-sample headline file, not the
    # 10k-sample subdir file
    assert points[15]["ref_tested"] == 100_000
    assert points[15]["ref_logical"] == 1


def test_corrected_fraction_parity_at_depth(artifact):
    """Corrected-fraction z (both sides' binomial noise) at the generation
    prior: |z| < 3 at EVERY point, where ours contributes ~1M samples."""
    _, points = artifact
    for w, rec in points.items():
        z = rec[f"z_corrected{_tag(w)}"]
        assert abs(z) < 3.0, f"W={w}: corrected-fraction z={z}"


def test_rare_event_count_parity(artifact):
    """Every rare-event counter at every point: the exact two-sample rate
    test must not reject at the 1% level (35 tests — a genuine semantic
    drift in e.g. the every-10 convergence band shows up as p ~ 0)."""
    _, points = artifact
    for w, rec in points.items():
        for c in COUNTERS:
            p = rec[f"pvalue_{c}{_tag(w)}"]
            assert p >= 0.01, f"W={w} {c}: two-sample p={p}"


def test_headline_ler_point(artifact):
    """The reference's headline evidence — 1 logical error in 100 000 at
    W=15 (SURVEY §6 row 5) — sits inside our 95% Poisson interval, decoded
    at the file's generation prior."""
    _, points = artifact
    rec = points[15]
    lo, hi = rec["ours_logical_rate_ci95_prior001"]
    assert lo <= rec["ref_logical_rate_prior001"] <= hi
    # and our own rate is pinned to the same 1e-5 regime
    assert 1e-6 <= rec["ours_logical_rate_prior001"] <= 3e-5


def test_conv_fail_curve_anchors(artifact):
    """The sharp conv-fail distributional signature (W=30: 4 -> W=58: 8632
    of 10k, DecoderCPU.h:514-521): our per-sample conv-fail-X rates must
    reproduce the curve's three-decade rise."""
    _, points = artifact
    rate = {w: points[w][f"ours_conv_x{_tag(w)}"]
            / points[w][f"ours_tested{_tag(w)}"] for w in (30, 40, 50, 58)}
    assert rate[30] < 2e-3              # ref 4/10000
    assert 0.02 < rate[40] < 0.12       # ref 563/10000
    assert 0.35 < rate[50] < 0.60       # ref 4831/10000
    assert 0.75 < rate[58] < 0.95       # ref 8632/10000
    assert rate[30] < rate[40] < rate[50] < rate[58]
