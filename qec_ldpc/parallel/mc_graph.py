"""Graph-parallel Monte-Carlo statistics: the (data x graph) mesh chunk.

Completes BASELINE config 5 end-to-end: the reference's whole value is its
statistics harness (``DecoderCPU::GetStatistics``, ``DecoderCPU.h:392-530``),
so the graph-sharded decoders of ``parallel/graph_sharded.py`` (block-column
sharding for circulant QC codes) and ``parallel/lifted_sharded.py``
(lift-lane band sharding for BB/HGP codes) must be drivable by it — not just
by a standalone decode call.

One fused shard_map chunk over a (data, graph) mesh:

  sample (data-local, graph-replicated) -> full syndromes (local compute)
  -> graph-sharded X/Z decode (halo collectives ride the ``graph`` axis)
  -> all_gather decisions over ``graph`` -> classify (graph-replicated)
  -> psum counters over ``data``.

Sample keys derive from (seed, chunk_id, data_index) EXACTLY as in the
data-parallel chunk (``parallel/montecarlo.py make_sharded_chunk``), so for
the exact decoders (min-sum, layered-min-sum — cross-shard min/sign
reductions are association-free) the counters BIT-MATCH a data-only mesh of
the same ``num_data``; sum-product reassociates cross-device products and
matches statistically (tests/test_mc_graph.py pins both).
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
from qec_ldpc.decoder.layout import CirculantGraph
from qec_ldpc.decoder.lifted import LiftedGraph
from qec_ldpc.decoder.sum_product import BPConfig
from qec_ldpc.parallel.graph_sharded import (
    ShardRouter,
    _decode_one_graph_sharded,
)
from qec_ldpc.parallel.lifted_sharded import ShardedLiftedGraph, _decode_one
from qec_ldpc.parallel.mesh import DATA_AXIS, GRAPH_AXIS
from qec_ldpc.sampling.classify import NUM_COUNTERS, classify_batch
from qec_ldpc.sampling.errors import (
    sample_depolarizing_errors,
    sample_weight_w_errors,
)


def _error_code(sfx, sfz, cfx, cfz):
    return (
        sfx.astype(jnp.int32) * SYNDROME_FAIL_X
        + sfz.astype(jnp.int32) * SYNDROME_FAIL_Z
        + cfx.astype(jnp.int32) * CONVERGENCE_FAIL_X
        + cfz.astype(jnp.int32) * CONVERGENCE_FAIL_Z
    )


def make_graph_sharded_chunk(mesh: Mesh, graphs: CodeGraphs, weight: int,
                             cfg: BPConfig, batch_per_device: int,
                             error_model: str = "weight",
                             relay_retries: int = 0):
    """Build a jitted (data x graph)-sharded Monte-Carlo chunk group.

    Same call contract as ``make_sharded_chunk``: the returned function takes
    ``(i_minus_p, key, error_probability, chunk_ids)`` and returns
    replicated ``(counters[NUM_COUNTERS], iters[2])``, scanning the chunk ids
    on device in one dispatch.  ``batch_per_device`` counts samples per
    DATA-shard (each graph shard works on the same samples).

    ``relay_retries > 0`` composes — failed lanes are repaired in place by
    graph-sharded damped retries (``graph_sharded._relay_one_graph_sharded``
    for circulant codes, ``lifted_sharded._relay_one_lifted`` for BB/HGP).
    """
    G = mesh.shape[GRAPH_AXIS]
    if G <= 1:
        raise ValueError("graph axis has size 1; use make_sharded_chunk")
    circulant = isinstance(graphs.x, CirculantGraph)
    if circulant:
        L = graphs.x.L
        if L % G != 0:
            raise ValueError(f"graph axis size {G} must divide L={L}")
        Lc = L // G
        x_router = ShardRouter(graphs.x, Lc, G)
        z_router = ShardRouter(graphs.z, Lc, G)
    else:
        if not isinstance(graphs.x, LiftedGraph):
            raise ValueError(f"unsupported graph type {type(graphs.x)!r}")
        for g in (graphs.x, graphs.z):
            if g.num_check_blocks != 1:
                # the band_slice below assumes the (single) check block's
                # lane grid is the whole syndrome axis; multi-block graphs
                # would straddle block boundaries (review finding r3)
                raise ValueError(
                    "graph-sharded statistics require one check block per "
                    f"lifted graph (got {g.num_check_blocks}); true for BB "
                    "and HGP codes")
        ax = ShardedLiftedGraph(graphs.x, G)
        az = ShardedLiftedGraph(graphs.z, G)
    n = graphs.code.n

    def sample(ck, error_probability):
        if error_model == "weight":
            return sample_weight_w_errors(ck, n, weight, batch_per_device)
        if error_model == "depolarizing":
            return sample_depolarizing_errors(ck, n, error_probability,
                                              batch_per_device)
        raise ValueError(f"unknown error model {error_model!r}")

    def decode_full(sx, sz, error_probability, relay_key=None):
        """Graph-sharded decode of full (replicated-over-graph) syndromes;
        returns decisions gathered back to GLOBAL variable order.  When
        ``relay_key`` is set (relay_retries > 0, circulant only), failed
        lanes are repaired in place by the graph-sharded relay loop."""
        prior = jnp.float32(cfg.prior_factor) * jnp.asarray(
            error_probability, jnp.float32)
        if circulant:
            dx_l, cfx, sfx, itx, _ = _decode_one_graph_sharded(
                graphs.x, Lc, sx, prior, x_router, cfg)
            dz_l, cfz, sfz, itz, _ = _decode_one_graph_sharded(
                graphs.z, Lc, sz, prior, z_router, cfg)
            if relay_key is not None:
                from qec_ldpc.parallel.graph_sharded import (
                    _relay_one_graph_sharded,
                )

                kx, kz = jax.random.split(relay_key)
                dx_l, solved_x, rx_it = _relay_one_graph_sharded(
                    graphs.x, Lc, sx, prior, x_router, cfg, kx,
                    dx_l, ~sfx, relay_retries)
                dz_l, solved_z, rz_it = _relay_one_graph_sharded(
                    graphs.z, Lc, sz, prior, z_router, cfg, kz,
                    dz_l, ~sfz, relay_retries)
                sfx, sfz = ~solved_x, ~solved_z
                itx, itz = itx + rx_it, itz + rz_it
            # device g owns block-columns [g*Lc, (g+1)*Lc): tiled gather IS
            # global variable order
            dx = lax.all_gather(dx_l, GRAPH_AXIS, axis=0, tiled=True)
            dz = lax.all_gather(dz_l, GRAPH_AXIS, axis=0, tiled=True)
        else:
            gidx = lax.axis_index(GRAPH_AXIS)
            band = ax.P  # local lanes per (single) check block

            def band_slice(s):
                return lax.dynamic_slice_in_dim(s, gidx * band, band, axis=0)

            sx_b, sz_b = band_slice(sx), band_slice(sz)
            dx_l, cfx, sfx, itx = _decode_one(ax, sx_b, prior, cfg)
            dz_l, cfz, sfz, itz = _decode_one(az, sz_b, prior, cfg)
            if relay_key is not None:
                from qec_ldpc.parallel.lifted_sharded import (
                    _relay_one_lifted,
                )

                kx, kz = jax.random.split(relay_key)
                dx_l, solved_x, rx_it = _relay_one_lifted(
                    ax, sx_b, prior, cfg, kx, dx_l, ~sfx, relay_retries)
                dz_l, solved_z, rz_it = _relay_one_lifted(
                    az, sz_b, prior, cfg, kz, dz_l, ~sfz, relay_retries)
                sfx, sfz = ~solved_x, ~solved_z
                itx, itz = itx + rx_it, itz + rz_it

            def reorder(d_l, g):
                # gathered (G, VB, lc, m, bt) band order -> (VB*l*m, bt)
                gd = lax.all_gather(d_l, GRAPH_AXIS)       # leading G axis
                bt = gd.shape[-1]
                gd = gd.reshape(G, g.num_var_blocks, g.lc, g.m, bt)
                return gd.transpose(1, 0, 2, 3, 4).reshape(-1, bt)

            dx, dz = reorder(dx_l, ax), reorder(dz_l, az)
        code = _error_code(sfx, sfz, cfx, cfz)
        return dx, dz, code, jnp.stack([itx, itz])

    def shard_fn(i_minus_p, key, error_probability, chunk_ids):
        didx = lax.axis_index(DATA_AXIS)

        def body(carry, c):
            counters, iters = carry
            # identical key derivation to the data-parallel chunk -> same
            # samples per (chunk, data-shard) regardless of the graph axis
            ck = jax.random.fold_in(jax.random.fold_in(key, c), didx)
            xe, ze = sample(ck, error_probability)
            xe_i = xe.astype(jnp.int32)
            ze_i = ze.astype(jnp.int32)
            # full syndromes: local compute, graph-replicated (the
            # single-device graph objects route with static rolls)
            sx = graphs.x.syndrome(xe_i)
            sz = graphs.z.syndrome(ze_i)
            relay_key = (jax.random.fold_in(ck, jnp.uint32(0x52454C41))
                         if relay_retries > 0 else None)
            dx, dz, code, its = decode_full(sx, sz, error_probability,
                                            relay_key)
            cnt = classify_batch(i_minus_p, xe_i, ze_i,
                                 dx.astype(jnp.int32), dz.astype(jnp.int32),
                                 code)
            its = its * batch_per_device  # executed lane-iterations [X, Z]
            return (counters + cnt, iters + its), None

        init = (jnp.zeros(NUM_COUNTERS, jnp.int32), jnp.zeros(2, jnp.int32))
        (counters, iters), _ = lax.scan(body, init, chunk_ids)
        # counters are graph-replicated by construction; reduce data axis
        return (lax.psum(counters, DATA_AXIS), lax.psum(iters, DATA_AXIS))

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def _check_graph_osd_mesh(mesh: Mesh, graphs: CodeGraphs, cfg: BPConfig,
                          batch: int):
    """Shared validation for the graph-sharded soft-output chunks; returns
    (G, num_data, bpd, Lc, x_router, z_router)."""
    if not isinstance(graphs.x, CirculantGraph):
        raise ValueError(
            "graph-sharded OSD arrays need circulant QC codes (the lifted "
            "lane-sharded engine has no soft outputs); use num_graph=1")
    G = mesh.shape[GRAPH_AXIS]
    num_data = mesh.shape[DATA_AXIS]
    if batch % num_data != 0:
        raise ValueError(f"batch={batch} must be divisible by the data-axis "
                         f"size {num_data}")
    bpd = batch // num_data
    L = graphs.x.L
    if L % G != 0:
        raise ValueError(f"graph axis size {G} must divide L={L}")
    Lc = L // G
    return (G, num_data, bpd, Lc,
            ShardRouter(graphs.x, Lc, G), ShardRouter(graphs.z, Lc, G))


def _soft_decode_shard(graphs: CodeGraphs, Lc, x_router, z_router,
                       cfg: BPConfig, weight: int, error_model: str,
                       relay_retries: int, batch: int, bpd: int,
                       key, error_probability):
    """Per-(data, graph)-shard body of the soft-output quality chunks:
    sample the FULL global batch from the single chunk key, slice this data
    shard's columns, graph-sharded X/Z decode with soft outputs, optional
    graph-sharded relay, decisions/soft gathered back to global variable
    order.  Returns (xe, ze, sx, sz, dx, dz, softx, softz, code, itx, itz)
    with itx/itz this shard's executed BP iteration counts (pre-psum)."""
    n = graphs.code.n
    didx = lax.axis_index(DATA_AXIS)
    if error_model == "weight":
        xe_f, ze_f = sample_weight_w_errors(key, n, weight, batch)
    elif error_model == "depolarizing":
        xe_f, ze_f = sample_depolarizing_errors(key, n,
                                                error_probability, batch)
    else:
        raise ValueError(f"unknown error model {error_model!r}")
    xe = lax.dynamic_slice_in_dim(xe_f, didx * bpd, bpd, axis=1)
    ze = lax.dynamic_slice_in_dim(ze_f, didx * bpd, bpd, axis=1)
    xe_i, ze_i = xe.astype(jnp.int32), ze.astype(jnp.int32)
    sx = graphs.x.syndrome(xe_i)
    sz = graphs.z.syndrome(ze_i)
    prior = jnp.float32(cfg.prior_factor) * jnp.asarray(
        error_probability, jnp.float32)
    dx_l, cfx, sfx, itx, softx_l = _decode_one_graph_sharded(
        graphs.x, Lc, sx, prior, x_router, cfg, want_soft=True)
    dz_l, cfz, sfz, itz, softz_l = _decode_one_graph_sharded(
        graphs.z, Lc, sz, prior, z_router, cfg, want_soft=True)
    if relay_retries > 0:
        from qec_ldpc.parallel.graph_sharded import (
            _relay_one_graph_sharded,
        )

        rk = jax.random.fold_in(key, jnp.uint32(0x52454C41))
        kx, kz = jax.random.split(rk)
        dx_l, solved_x, rx_it = _relay_one_graph_sharded(
            graphs.x, Lc, sx, prior, x_router, cfg, kx, dx_l, ~sfx,
            relay_retries)
        dz_l, solved_z, rz_it = _relay_one_graph_sharded(
            graphs.z, Lc, sz, prior, z_router, cfg, kz, dz_l, ~sfz,
            relay_retries)
        sfx, sfz = ~solved_x, ~solved_z
        itx, itz = itx + rx_it, itz + rz_it
    dx = lax.all_gather(dx_l, GRAPH_AXIS, axis=0, tiled=True)
    dz = lax.all_gather(dz_l, GRAPH_AXIS, axis=0, tiled=True)
    softx = lax.all_gather(softx_l, GRAPH_AXIS, axis=0, tiled=True)
    softz = lax.all_gather(softz_l, GRAPH_AXIS, axis=0, tiled=True)
    code = _error_code(sfx, sfz, cfx, cfz)
    return (xe, ze, sx, sz, dx, dz, softx, softz, code, itx, itz)


def make_graph_sharded_arrays_chunk(mesh: Mesh, graphs: CodeGraphs,
                                    weight: int, cfg: BPConfig, batch: int,
                                    error_model: str = "weight",
                                    relay_retries: int = 0):
    """One Monte-Carlo chunk over a (data x graph) mesh returning the FULL
    per-lane arrays for host post-processing — the graph-sharded sibling of
    ``mc_chunk_arrays`` (debugging/analysis; the production quality mode
    uses :func:`make_graph_sharded_osd_chunk`).

    Sampling uses ONE key for the whole global ``batch`` (each data shard
    slices its columns), so the sample stream is identical to
    ``mc_chunk_arrays(key, ..., batch)`` — and with the exact min-sum
    engine the decisions AND soft outputs bit-match the single-device path.
    Circulant QC codes only (the lifted lane-sharded engine has no soft
    outputs).  Returns ``(xe, ze, sx, sz, result: DecodeResult)``.

    Accounting caveat (advisor r3): only COUNTERS are partition-invariant.
    ``iter_samples_*`` sums each data shard's own early-exit loop count
    (x bpd), and shards stop at different check-every boundaries, so
    iteration TOTALS are mesh-shape-dependent (the honest per-shard work,
    not the single-device loop's).
    """
    from qec_ldpc.decoder.decode import DecodeResult

    G, num_data, bpd, Lc, x_router, z_router = _check_graph_osd_mesh(
        mesh, graphs, cfg, batch)

    def shard_fn(key, error_probability):
        (xe, ze, sx, sz, dx, dz, softx, softz, code, itx,
         itz) = _soft_decode_shard(
            graphs, Lc, x_router, z_router, cfg, weight, error_model,
            relay_retries, batch, bpd, key, error_probability)
        isx = lax.psum(itx * bpd, DATA_AXIS)
        isz = lax.psum(itz * bpd, DATA_AXIS)
        return (xe.astype(jnp.int8), ze.astype(jnp.int8),
                sx.astype(jnp.int8), sz.astype(jnp.int8),
                dx, dz, softx, softz, code, isx, isz)

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(None, DATA_AXIS),) * 8 + (P(DATA_AXIS), P(), P()),
        check_vma=False,
    )
    jitted = jax.jit(mapped)

    def chunk_fn(key, error_probability):
        (xe, ze, sx, sz, dx, dz, softx, softz, code,
         isx, isz) = jitted(key, jnp.float32(error_probability))
        res = DecodeResult(
            decisions_x=dx, decisions_z=dz, error_code=code,
            iters_x=jnp.int32(0), iters_z=jnp.int32(0),
            iter_samples_x=isx, iter_samples_z=isz,
            soft_x=softx, soft_z=softz)
        return xe, ze, sx, sz, res

    return chunk_fn


def make_graph_sharded_osd_chunk(mesh: Mesh, graphs: CodeGraphs,
                                 weight: int, cfg: BPConfig, batch: int,
                                 error_model: str = "weight",
                                 relay_retries: int = 0):
    """The graph-sharded device chunk of the FAST quality mode (VERDICT r3
    #2): same call contract as ``montecarlo.make_osd_chunk`` —
    ``(i_minus_p, key, p) -> (counters_ok, iters[2], nfail, bundle)`` — with the decode sharded over the graph axis.  Non-failed
    lanes classify on device (graph-replicated classification, counters
    psum'd over the data axis); failed lanes are compacted first within
    each data shard for prefix-only host fetch.

    NOTE on multi-host: bundle columns are REPLICATED over the graph axis,
    so the host must fetch each data shard's columns from exactly one graph
    replica — ``montecarlo._gather_failed_lanes(owned_starts=...)`` handles
    the dedup/ownership."""
    from qec_ldpc.decoder.decode import DecodeResult
    from qec_ldpc.parallel.montecarlo import _classify_and_compact

    G, num_data, bpd, Lc, x_router, z_router = _check_graph_osd_mesh(
        mesh, graphs, cfg, batch)

    def shard_fn(i_minus_p, key, error_probability):
        (xe, ze, sx, sz, dx, dz, softx, softz, code, itx,
         itz) = _soft_decode_shard(
            graphs, Lc, x_router, z_router, cfg, weight, error_model,
            relay_retries, batch, bpd, key, error_probability)
        res = DecodeResult(
            decisions_x=dx, decisions_z=dz, error_code=code,
            iters_x=jnp.int32(0), iters_z=jnp.int32(0),
            iter_samples_x=itx * bpd, iter_samples_z=itz * bpd,
            soft_x=softx, soft_z=softz)
        counters, nfail, bundle = _classify_and_compact(
            i_minus_p, xe.astype(jnp.int32), ze.astype(jnp.int32),
            sx, sz, res)
        iters = jnp.stack([res.iter_samples_x, res.iter_samples_z])
        return (lax.psum(counters, DATA_AXIS), lax.psum(iters, DATA_AXIS),
                nfail[None], bundle)

    bundle_specs = (P(None, DATA_AXIS),) * 8 + (P(DATA_AXIS),)
    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P(), P(DATA_AXIS), bundle_specs),
        check_vma=False,
    )
    return jax.jit(mapped)
