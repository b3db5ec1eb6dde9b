"""Compiled collective structure of the sharded engines (VERDICT r3 #4).

The graph-sharded design claims (``parallel/graph_sharded.py`` docstring,
SURVEY §5 interconnect design) are asserted here against the COMPILED program: lower
each sharded decoder on the CPU test mesh, extract the BP while-loop bodies
from the StableHLO text, and count the collectives.  If XLA or a refactor
ever un-fuses the halo exchange (one gather becoming per-block gathers),
these counts jump and the test fails.

Design numbers asserted:
  * flooding sum-product: exactly ONE all_gather per BP iteration per graph
    (the fused halo exchange of CN partial products);
  * flooding min-sum:    exactly ONE all_gather per iteration (packed
    (min, sign) exchange — two logical reductions, one collective);
  * layered min-sum:     exactly B packed all_gathers per sweep (one per
    block-row layer — same bytes as flooding, more latency);
  * lane-sharded lifted: collective_permute halo rolls only (no gathers in
    the loop), with ppermutes grouped by ring offset — O(#offsets), not
    O(edge blocks).
"""

import jax
import jax.numpy as jnp
import pytest

from qec_ldpc.codes import construct_code, known_bicycle_code
from qec_ldpc.decoder import BPConfig, CodeGraphs
from qec_ldpc.harness.hlo_inspect import loop_collective_summary
from qec_ldpc.parallel import make_mesh
from qec_ldpc.parallel.graph_sharded import make_graph_sharded_decoder
from qec_ldpc.parallel.lifted_sharded import make_lifted_sharded_decoder

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

G = 3          # graph-axis size (divides L=6 of the P=7 code)
BATCH = 8      # tiny global batch; counts are shape-independent


@pytest.fixture(scope="module")
def lowered():
    code = construct_code(3, 3, 6, 7, 2, 3)
    graphs = CodeGraphs.build(code)
    mesh = make_mesh(num_data=2, num_graph=G)
    sx = jnp.zeros((code.num_eqs_x, BATCH), jnp.int32)
    sz = jnp.zeros((code.num_eqs_z, BATCH), jnp.int32)

    def lower(algo):
        cfg = BPConfig(max_iters=20, algorithm=algo)
        dec = make_graph_sharded_decoder(mesh, graphs, cfg)
        return loop_collective_summary(
            jax.jit(dec).lower(sx, sz, 0.02).as_text())

    return {algo: lower(algo)
            for algo in ("sum-product", "min-sum", "layered-min-sum")}


def test_flooding_sum_product_one_gather_per_iteration(lowered):
    s = lowered["sum-product"]
    # one while loop per graph (X and Z), ONE fused all_gather in each body
    assert [b.counts["all_gather"] for b in s["bodies"]] == [1, 1]
    assert s["outside"].counts["all_gather"] == 0
    # the halo payload is the (G, B, P*bt_local) partial-product tensor:
    # G * B * P * (BATCH/num_data) * 4 bytes
    bt_local = BATCH // 2
    expect = G * 3 * 7 * bt_local * 4
    assert [b.result_bytes["all_gather"] for b in s["bodies"]] == [expect] * 2


def test_flooding_min_sum_one_packed_gather_per_iteration(lowered):
    """The (min, sign) pair rides ONE collective (packed, 2x payload), the
    same count as sum-product's single product gather."""
    s = lowered["min-sum"]
    assert [b.counts["all_gather"] for b in s["bodies"]] == [1, 1]
    assert s["outside"].counts["all_gather"] == 0
    bt_local = BATCH // 2
    expect = 2 * G * 3 * 7 * bt_local * 4  # stacked (min, sign)
    assert [b.result_bytes["all_gather"] for b in s["bodies"]] == [expect] * 2


def test_layered_b_gathers_per_sweep(lowered):
    """One packed (min, sign) gather per block-row layer per sweep: B = 3
    for both graphs of the P=7 code — same bytes per sweep as flooding
    (B gathers of 1/B-size payloads x the packed factor)."""
    s = lowered["layered-min-sum"]
    assert [b.counts["all_gather"] for b in s["bodies"]] == [3, 3]
    assert s["outside"].counts["all_gather"] == 0
    bt_local = BATCH // 2
    per_layer = 2 * G * 1 * 7 * bt_local * 4
    assert [b.result_bytes["all_gather"] for b in s["bodies"]] \
        == [3 * per_layer] * 2


def test_no_stray_collectives_in_decode_loops(lowered):
    """The loop bodies must contain NO collective other than the designed
    halo gather and the convergence-flag all_reduce (pmax/psum of one
    bool per lane — mesh-global continue flag)."""
    for algo, s in lowered.items():
        for b in s["bodies"]:
            assert b.counts["collective_permute"] == 0, algo
            assert b.counts["all_to_all"] == 0, algo
            # convergence continue-flag reduction only (at most 1 per body;
            # layered folds it into the same layer loop)
            assert b.counts["all_reduce"] <= 2, (algo, b.counts)


def test_lifted_lane_sharded_offset_grouped_permutes():
    """BB [[144,12,12]] lane-sharded decode: halo rolls are ppermutes
    GROUPED BY RING OFFSET (``ShardedLiftedGraph._roll_many``) — 2 per BP
    iteration for this code/mesh (one concatenated permute per distinct
    nonzero source offset per routing pass), NOT O(edge blocks) = 12+; and
    no all_gathers inside the loop at all."""
    bb = known_bicycle_code("[[144,12,12]]")
    graphs = bb.build_graphs()
    mesh = make_mesh(num_data=2, num_graph=4)
    sx = jnp.zeros((bb.num_eqs_x, BATCH), jnp.int32)
    sz = jnp.zeros((bb.num_eqs_z, BATCH), jnp.int32)
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    dec = make_lifted_sharded_decoder(mesh, graphs, cfg)
    s = loop_collective_summary(jax.jit(dec).lower(sx, sz, 0.02).as_text())
    assert [b.counts["collective_permute"] for b in s["bodies"]] == [2, 2]
    assert all(b.counts["all_gather"] == 0 for b in s["bodies"])
    # a handful of routing permutes outside the loop (final posterior /
    # decision reordering), nowhere near the per-block naive count
    assert s["outside"].counts["collective_permute"] <= 6
