"""Lane-sharded decode for lifted graphs: ppermute halo exchange between devices.

Graph parallelism for the lifted code families (bivariate bicycle,
hypergraph products / toric — codes/bicycle.py, codes/hypergraph.py), which
``parallel/graph_sharded.py`` cannot cover: its design shards *block
columns*, and the lifted families have only two var blocks.  Here the
sharded dimension is the **lift group's first axis**: for group
Z_l x Z_m each of G devices (G | l) owns a contiguous band of ``l/G`` rows
of the (l, m) lane grid — of every check lane, var lane, and edge lane
alike.

With lanes sharded this way, BOTH message updates are fully local compute:
a check row and all of its incident edge lanes live on one device.  The
only communication is the routing itself — a lifted-graph roll by (a, b)
moves the whole band by ``a`` rows, which is a **halo exchange**: two
``jax.lax.ppermute`` ring shifts (to neighbors ``a // lc`` and
``a // lc + 1``) and a static stitch of the received bands
(``out = concat(recv_d[r:], recv_d1[:r])``, r = a mod lc).  This is
precisely the "cyclic rolls within lanes = cheap interconnect permutes" design of
SURVEY §5 — nearest-neighbor traffic for small shifts, no all_gather, no
psum in the iteration loop.

Because rolls are exact permutations and every arithmetic reduction stays
device-local in the same order as the single-device path, the sharded
decode is **bit-identical** to ``decode_batch`` for both min-sum and
sum-product (asserted in tests/test_lifted_sharded.py) — stronger than the
block-column design, whose cross-device sum-product products reassociate.

**Why there is no k-iterations-per-call fused kernel between halos**: a
fused kernel would pay off by keeping the edge
state on-chip ACROSS iterations — but a sharded iteration must surface its
messages to the halo exchange every iteration, so a between-halos kernel
could only fuse one iteration's local arithmetic, which XLA already fuses
from the shard_map program.  Fusing k
iterations requires deep halos (ghost regions growing by k x max-shift rows
per step); BB shifts span most of the lift height (a=3..19 of l=21), so the
ghost region IS the array and nothing is saved.  The productive lever at
this layer is collective COUNT, addressed by :meth:`_roll_many` below
(offset-grouped ppermutes).  A deep-halo kernel stays worthwhile only for
shift<=1 families (the toric code) and is deliberately not special-cased.

Mechanism: :class:`ShardedLiftedGraph` duck-types
:class:`~qec_ldpc.decoder.lifted.LiftedGraph` with local shapes and
halo rolls, so the *unmodified* graph-generic drivers
(``decoder/min_sum.min_sum_run``, ``decoder/sum_product.bp_run``) run
inside ``shard_map``.  The adapter's ``combine_lane_mask`` hook pmax-merges
the convergence mask across the graph axis so every shard's ``while_loop``
executes the same trip count (collectives inside the body would deadlock
otherwise).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from qec_ldpc.decoder.decode import (
    CONVERGENCE_FAIL_X,
    CONVERGENCE_FAIL_Z,
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
)
from qec_ldpc.decoder.lifted import LiftedGraph, _neg
from qec_ldpc.decoder.min_sum import (
    _not_converged_mask_llr,
    min_sum_run,
    np_log_band,
)
from qec_ldpc.decoder.sum_product import _not_converged_mask, bp_run
from qec_ldpc.parallel.mesh import DATA_AXIS, GRAPH_AXIS


class ShardedLiftedGraph:
    """The local (per-device) view of a LiftedGraph with its (l, m) lane grid
    band-sharded over ``G`` devices along the l axis.

    Duck-type identical to LiftedGraph from the decoders' point of view, with
    every size replaced by its local value (P -> lc * m) and every roll's
    l-axis component implemented as a ppermute halo exchange.  Must be used
    inside a shard_map over a mesh with a ``graph`` axis of size G.
    """

    def __init__(self, base: LiftedGraph, G: int):
        if len(base.group) != 2:
            raise ValueError("lane sharding needs a product group (l, m); "
                             "use parallel/graph_sharded.py for Z_P codes")
        l, m = base.group
        if l % G != 0:
            raise ValueError(f"graph axis size {G} must divide l={l}")
        self.base = base
        self.G = G
        self.l, self.m = l, m
        self.lc = l // G
        self.P = self.lc * m  # local lanes per block
        self.num_check_blocks = base.num_check_blocks
        self.num_var_blocks = base.num_var_blocks
        self.check_degree = base.check_degree
        self.var_degree = base.var_degree
        self.num_checks = self.num_check_blocks * self.P
        self.num_vars = self.num_var_blocks * self.P
        self.num_edge_blocks = base.num_edge_blocks
        self.num_edges = self.num_edge_blocks * self.P

    # -- halo-exchange roll -------------------------------------------------

    def _shift_bands(self, y: jnp.ndarray, d: int) -> jnp.ndarray:
        """Receive the whole local band from the device ``d`` ring positions
        ahead (one ppermute; identity when that is ourselves)."""
        d = d % self.G
        if d == 0:
            return y
        perm = [((g + d) % self.G, g) for g in range(self.G)]
        return lax.ppermute(y, GRAPH_AXIS, perm)

    def _roll(self, x: jnp.ndarray, shift: tuple[int, int]) -> jnp.ndarray:
        """out[r] = x[(r + shift) % (l, m)] on a LOCAL (lc*m, batch) chunk.
        m-axis component is a local static roll; l-axis component fetches the
        two source bands via ppermute and stitches them."""
        return self._roll_many([x], [shift])[0]

    def _roll_many(self, xs: list[jnp.ndarray],
                   shifts: list[tuple[int, int]]) -> list[jnp.ndarray]:
        """Batched halo exchange: roll each local chunk ``xs[e]`` by
        ``shifts[e]``, with ALL blocks' ppermutes grouped by ring offset.

        A block's l-shift ``a`` decomposes as (d, r) = divmod(a, lc): it
        needs the band from ``d`` ring positions ahead and (when r != 0)
        also from ``d+1``.  Naively that is up to 2 ppermutes PER edge block
        per routing direction; here every block needing the same source
        offset rides ONE ppermute of a concatenated tensor, so an iteration
        pays O(#distinct offsets) collectives (typically 2-3: offsets 0/1
        for nearest-neighbor shifts) instead of O(edge blocks).  Collective
        BYTES are unchanged — this cuts per-collective launch/rendezvous
        latency, the dominant term for small lifted codes.
        Bit-identical to per-block rolls (same permutation, same stitch).
        """
        n = len(xs)
        ys, decomp = [], []
        for e in range(n):
            a, b = shifts[e]
            y = xs[e].reshape(self.lc, self.m, *xs[e].shape[1:])
            if b:
                y = jnp.roll(y, -b, axis=1)
            a %= self.l
            d, r = divmod(a, self.lc)
            ys.append(y)
            decomp.append((d, r))
        # offset -> list of block ids whose source band lives there
        needed: dict[int, list[int]] = {}
        for e, (d, r) in enumerate(decomp):
            needed.setdefault(d % self.G, []).append(e)
            if r:
                needed.setdefault((d + 1) % self.G, []).append(e)
        recv: dict[tuple[int, int], jnp.ndarray] = {}
        for off in sorted(needed):
            es = needed[off]
            if off == 0:
                for e in es:
                    recv[(e, off)] = ys[e]
                continue
            perm = [((g + off) % self.G, g) for g in range(self.G)]
            cat = lax.ppermute(jnp.concatenate([ys[e] for e in es], axis=0),
                               GRAPH_AXIS, perm)
            for i, e in enumerate(es):
                recv[(e, off)] = lax.slice_in_dim(
                    cat, i * self.lc, (i + 1) * self.lc, axis=0)
        out = []
        for e, (d, r) in enumerate(decomp):
            recv_d = recv[(e, d % self.G)]
            if r:
                recv_d1 = recv[(e, (d + 1) % self.G)]
                y = jnp.concatenate(
                    [lax.slice_in_dim(recv_d, r, self.lc, axis=0),
                     lax.slice_in_dim(recv_d1, 0, r, axis=0)], axis=0)
            else:
                y = recv_d
            out.append(y.reshape(xs[e].shape))
        return out

    # -- LiftedGraph interface (local shapes) --------------------------------

    def _chunk(self, x: jnp.ndarray, i: int) -> jnp.ndarray:
        return lax.slice_in_dim(x, i * self.P, (i + 1) * self.P, axis=0)

    def to_var(self, x: jnp.ndarray) -> jnp.ndarray:
        b = self.base
        rolled = self._roll_many(
            [self._chunk(x, e) for e in b._var_rank_edges],
            [_neg(b.shifts[e], b.group) for e in b._var_rank_edges])
        return jnp.concatenate(rolled, axis=0)

    def to_check(self, x: jnp.ndarray) -> jnp.ndarray:
        b = self.base
        es = range(b.num_edge_blocks)
        rolled = self._roll_many(
            [self._chunk(x, b._var_pos[e]) for e in es],
            [b.shifts[e] for e in es])
        return jnp.concatenate(rolled, axis=0)

    def syndrome(self, errors: jnp.ndarray) -> jnp.ndarray:
        """LOCAL checks' mod-2 syndrome of the (locally banded) error vector;
        halo rolls fetch the cross-band variables, so no reduction collective
        is needed (each check is whole on its device)."""
        b = self.base
        es = range(b.num_edge_blocks)
        rolled = self._roll_many(
            [self._chunk(errors, b.var_blocks[e]) for e in es],
            [b.shifts[e] for e in es])
        rows = []
        e = 0
        for _c in range(b.num_check_blocks):
            acc = None
            for _ in range(b.check_degree):
                blk = rolled[e]
                acc = blk if acc is None else acc + blk
                e += 1
            rows.append(acc)
        return jnp.concatenate(rows, axis=0) % 2

    def cn_view(self, x: jnp.ndarray) -> jnp.ndarray:
        return x.reshape(self.num_check_blocks, self.check_degree, -1)

    def vn_view(self, x: jnp.ndarray) -> jnp.ndarray:
        return x.reshape(self.var_degree, self.num_vars, -1)

    def expand_checks(self, s: jnp.ndarray) -> jnp.ndarray:
        c_p = s.reshape(self.num_check_blocks, 1, self.P, -1)
        full = jnp.broadcast_to(
            c_p, (self.num_check_blocks, self.check_degree, self.P,
                  s.shape[-1]))
        return full.reshape(self.num_edges, -1)

    def expand_vars(self, g: jnp.ndarray) -> jnp.ndarray:
        full = jnp.broadcast_to(g[None], (self.var_degree, *g.shape))
        return self.to_check(full.reshape(self.num_edges, -1))

    # -- sharding hooks -------------------------------------------------------

    def combine_lane_mask(self, mask: jnp.ndarray) -> jnp.ndarray:
        """OR a per-batch-lane boolean across the graph shards."""
        return lax.pmax(mask.astype(jnp.int32), GRAPH_AXIS) > 0

    def combine_continue(self, cont: jnp.ndarray) -> jnp.ndarray:
        """OR the loop-continue flag across the WHOLE mesh: XLA's
        collective-permute rendezvous spans all devices, so even data shards
        must take the same trip count (their finished lanes stay frozen by
        the ``done`` mask; the count equals the single-device one, which
        also runs until the globally-slowest lane converges)."""
        return lax.pmax(cont.astype(jnp.int32),
                        (GRAPH_AXIS, DATA_AXIS)) > 0


def _decode_one(adapter: ShardedLiftedGraph, syndrome: jnp.ndarray,
                prior: jnp.ndarray, cfg):
    """Local decode of one graph inside shard_map.  Returns
    (decisions (num_vars_local, bt) int8, conv_fail, syn_fail, iters)."""
    if cfg.algorithm == "min-sum":
        prior_arr = jnp.asarray(prior, jnp.float32)
        v, iters = min_sum_run(adapter, syndrome, prior_arr, cfg.max_iters,
                               check_every=cfg.check_every,
                               conv_low=cfg.conv_low,
                               alpha=cfg.min_sum_alpha)
        vv = adapter.vn_view(adapter.to_var(v))
        decisions = jnp.any(vv <= 0.0, axis=0)
        band = float(np_log_band(cfg.conv_low))
        conv_fail = adapter.combine_lane_mask(
            _not_converged_mask_llr(v, band))
    elif cfg.algorithm == "sum-product":
        v, iters = bp_run(adapter, syndrome, jnp.asarray(prior, jnp.float32),
                          cfg.max_iters, check_every=cfg.check_every,
                          conv_low=cfg.conv_low, conv_high=cfg.conv_high)
        vv = adapter.vn_view(adapter.to_var(v))
        decisions = jnp.any(vv >= cfg.hard_threshold, axis=0)
        conv_fail = adapter.combine_lane_mask(
            _not_converged_mask(v, cfg.conv_low, cfg.conv_high))
    else:
        raise ValueError(
            f"lane-sharded decode supports sum-product/min-sum, "
            f"not {cfg.algorithm!r}")
    s_hat = adapter.syndrome(decisions.astype(jnp.int32))
    syn_fail = adapter.combine_lane_mask(jnp.any(s_hat != syndrome, axis=0))
    return decisions.astype(jnp.int8), conv_fail, syn_fail, iters


def _relay_one_lifted(adapter: ShardedLiftedGraph, syndrome: jnp.ndarray,
                      prior, cfg, key, decisions0, solved0, retries: int,
                      gamma_low: float = 0.05, gamma_high: float = 1.0):
    """Lane-sharded image of decoder/relay._relay_one_graph: damped min-sum
    retries inside shard_map with ppermute halos.  Each device draws damping
    for its own variable band; ``expand_vars``'s halo rolls deliver every
    edge its variable's coefficient.  The retry loop's continue flag is
    mesh-global (``combine_continue``) because the in-loop ppermutes
    rendezvous across all devices.  Returns (decisions, solved, trip_iters).
    """
    bt = syndrome.shape[-1]
    gidx = lax.axis_index(GRAPH_AXIS)
    prior_arr = jnp.asarray(prior, jnp.float32)

    def cond(state):
        r, _, solved, _ = state
        return adapter.combine_continue((r < retries) & ~jnp.all(solved))

    def body(state):
        r, decisions, solved, acc = state
        rk = jax.random.fold_in(jax.random.fold_in(key, r), gidx)
        gamma = jax.random.uniform(rk, (adapter.num_vars, bt), jnp.float32,
                                   gamma_low, gamma_high)
        damping = adapter.expand_vars(gamma)
        s_eff = jnp.where(solved[None, :], 0, syndrome)
        v, it = min_sum_run(adapter, s_eff, prior_arr, cfg.max_iters,
                            check_every=cfg.check_every,
                            conv_low=cfg.conv_low, alpha=cfg.min_sum_alpha,
                            damping=damping)
        vv = adapter.vn_view(adapter.to_var(v))
        d_new = jnp.any(vv <= 0.0, axis=0).astype(decisions.dtype)
        s_hat = adapter.syndrome(d_new.astype(jnp.int32))
        mismatch = adapter.combine_lane_mask(
            jnp.any(s_hat != syndrome, axis=0))
        newly = ~mismatch & ~solved
        decisions = jnp.where(newly[None, :], d_new, decisions)
        return r + 1, decisions, solved | newly, acc + it

    _, decisions, solved, trip_iters = lax.while_loop(
        cond, body, (jnp.int32(0), decisions0, solved0, jnp.int32(0)))
    return decisions, solved, trip_iters


def make_lifted_sharded_decoder(mesh: Mesh, graphs: CodeGraphs, cfg):
    """Build a jitted lane-sharded decode over a (data, graph) mesh.

    Returns ``decode(syndrome_x (num_checks, batch), syndrome_z,
    error_probability) -> (decisions_x (n, batch), decisions_z, error_code
    (batch,), iters (num_data, 2))`` with batch sharded over ``data`` and
    every lane grid band-sharded over ``graph``.  Requires single-check-block
    lifted graphs (true for BB and HGP codes) so the check axis shards
    contiguously, and G | l.
    """
    G = mesh.shape[GRAPH_AXIS]
    for g in (graphs.x, graphs.z):
        if not isinstance(g, LiftedGraph):
            raise ValueError("lane sharding is for LiftedGraph codes; use "
                             "make_graph_sharded_decoder for circulant codes")
        if g.num_check_blocks != 1:
            raise ValueError("lane sharding requires one check block "
                             f"(got {g.num_check_blocks})")
    # fail loudly on BPConfig features this path cannot honor (it would
    # otherwise silently drop soft outputs)
    if getattr(cfg, "return_soft", False):
        raise ValueError(
            "cfg.return_soft is not supported by the lane-sharded decoder "
            "(no soft outputs -> no OSD composition); decode with "
            "decode_batch for OSD post-processing")
    ax = ShardedLiftedGraph(graphs.x, G)
    az = ShardedLiftedGraph(graphs.z, G)
    num_data = mesh.shape[DATA_AXIS]

    def shard_fn(sx, sz, p):
        prior = jnp.float32(cfg.prior_factor) * jnp.asarray(p, jnp.float32)
        dx, cfx, sfx, itx = _decode_one(ax, sx, prior, cfg)
        dz, cfz, sfz, itz = _decode_one(az, sz, prior, cfg)
        code = (
            sfx.astype(jnp.int32) * SYNDROME_FAIL_X
            + sfz.astype(jnp.int32) * SYNDROME_FAIL_Z
            + cfx.astype(jnp.int32) * CONVERGENCE_FAIL_X
            + cfz.astype(jnp.int32) * CONVERGENCE_FAIL_Z
        )
        iters = jnp.stack([itx, itz])[None]
        return dx, dz, code, iters

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(
            P(GRAPH_AXIS, DATA_AXIS),   # check lanes band-sharded (CB == 1)
            P(GRAPH_AXIS, DATA_AXIS),
            P(),
        ),
        out_specs=(
            P(GRAPH_AXIS, DATA_AXIS),   # local (VB, lc, m) bands
            P(GRAPH_AXIS, DATA_AXIS),
            P(DATA_AXIS),
            P(DATA_AXIS, None),
        ),
    )
    jitted = jax.jit(mapped)

    def _reorder(d: jnp.ndarray, g: ShardedLiftedGraph) -> jnp.ndarray:
        """Gathered (G, VB, lc, m) band order -> global (VB, l, m) order."""
        batch = d.shape[-1]
        out = d.reshape(G, g.num_var_blocks, g.lc, g.m, batch)
        return out.transpose(1, 0, 2, 3, 4).reshape(-1, batch)

    def decode(syndrome_x, syndrome_z, error_probability):
        # validate before the jitted shard_map so violations surface as a
        # decoder-level message, not a cryptic sharding error
        for name, s, g in (("syndrome_x", syndrome_x, graphs.x),
                           ("syndrome_z", syndrome_z, graphs.z)):
            if s.ndim != 2 or s.shape[0] != g.num_checks:
                raise ValueError(
                    f"{name} must be ({g.num_checks}, batch) in GLOBAL "
                    f"check order, got {s.shape}")
        batch = syndrome_x.shape[-1]
        if syndrome_z.shape[-1] != batch:
            raise ValueError(
                f"syndrome batch sizes differ: {batch} vs "
                f"{syndrome_z.shape[-1]}")
        if batch % num_data != 0:
            raise ValueError(
                f"batch={batch} must be divisible by the data-axis size "
                f"{num_data}")
        dx, dz, code, iters = jitted(syndrome_x, syndrome_z,
                                     jnp.float32(error_probability))
        return _reorder(dx, ax), _reorder(dz, az), code, iters

    return decode
