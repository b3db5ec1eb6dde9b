"""Sharded Monte-Carlo estimation of logical-error statistics.

Device-batched replacement for the reference's OpenMP statistics harness
(``DecoderCPU::GetStatistics``, ``DecoderCPU.h:392-530``): host threads with a
locked shared RNG and atomic counters become device-batched decodes over a
``data`` mesh axis with counter-based per-sample keys and a ``psum`` reduction
(SURVEY §2 native-inventory item 4).

One fused jit step per chunk:
  sample errors -> syndromes -> batched X/Z BP decode -> classify -> counters.

The same step runs single-device (plain jit) or sharded (shard_map over the
mesh); statistical results are identical because sample keys are derived from
(seed, global sample index), independent of the device partition.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from qec_ldpc.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    decode_batch,
)
from qec_ldpc.decoder.sum_product import BPConfig
from qec_ldpc.parallel.mesh import DATA_AXIS, GRAPH_AXIS
from qec_ldpc.sampling.classify import (
    NUM_COUNTERS,
    RankBasisTest,
    classify_batch,
    make_rank_basis_test,
)
from qec_ldpc.sampling.errors import (
    sample_depolarizing_errors,
    sample_weight_w_errors,
    sample_weight_w_errors_dynamic,
)


def _resolve_logical_test(graphs: CodeGraphs, i_minus_p):
    """None -> rank-basis test of the code (reference convention); dense
    arrays pass through as jnp arrays; RankBasisTest passes through."""
    if i_minus_p is None:
        return make_rank_basis_test(graphs.code)
    if isinstance(i_minus_p, RankBasisTest):
        return i_minus_p
    return jnp.asarray(i_minus_p)


def _sample_and_decode(graphs: CodeGraphs, key: jax.Array, weight: int,
                       error_probability, cfg: BPConfig, batch: int,
                       error_model: str,
                       relay_retries: int = 0, mesh: Mesh | None = None,
                       weight_cap: int | None = None):
    """The shared device pipeline: sample errors -> syndromes -> decode
    (ensemble-relay-repaired when ``relay_retries > 0``, decoder/relay.py).
    Returns (xe, ze, sx, sz, res) with errors as int32.

    ``weight_cap``: when set (static), ``weight`` is a RUNTIME value and
    the dynamic sampler draws ``weight_cap`` candidates — so a whole weight
    sweep shares ONE compiled program (a 60-point sweep compiles once).  At
    ``weight == weight_cap`` the draws are bit-identical to the static
    sampler.

    Single source of truth for BOTH the counter path (:func:`_chunk_body`)
    and the array path (:func:`mc_chunk_arrays`) — the quality drivers'
    seed-for-seed sample parity with :func:`run_monte_carlo` depends on
    these staying identical."""
    n = graphs.code.n
    if error_model == "weight":
        if weight_cap is not None:
            xe, ze = sample_weight_w_errors_dynamic(key, n, weight,
                                                    weight_cap, batch)
        else:
            xe, ze = sample_weight_w_errors(key, n, weight, batch)
    elif error_model == "depolarizing":
        xe, ze = sample_depolarizing_errors(key, n, error_probability, batch)
    else:
        raise ValueError(f"unknown error model {error_model!r}")
    if mesh is not None:
        # batch axis over the data mesh axis; GSPMD propagates through the
        # whole (batch-elementwise) decode — value-identical to unsharded
        shard = jax.sharding.NamedSharding(mesh, P(None, DATA_AXIS))
        xe = jax.lax.with_sharding_constraint(xe, shard)
        ze = jax.lax.with_sharding_constraint(ze, shard)
    xe_i = xe.astype(jnp.int32)
    ze_i = ze.astype(jnp.int32)
    sx = graphs.x.syndrome(xe_i)
    sz = graphs.z.syndrome(ze_i)
    if relay_retries > 0:
        from qec_ldpc.decoder.relay import relay_decode_batch

        relay_key = jax.random.fold_in(key, jnp.uint32(0x52454C41))
        res, _, _ = relay_decode_batch(
            graphs, sx, sz, error_probability, relay_key, cfg,
            retries=relay_retries)
    else:
        res = decode_batch(graphs, sx, sz, error_probability, cfg)
    return xe_i, ze_i, sx, sz, res


def _chunk_body(graphs: CodeGraphs, i_minus_p: jnp.ndarray, key: jax.Array,
                weight: int, error_probability, cfg: BPConfig, batch: int,
                error_model: str, relay_retries: int = 0,
                weight_cap: int | None = None):
    """Sample + decode + classify one batch.  Returns (counters[NUM_COUNTERS],
    iters[2]) with iters = executed BP lane-iterations (sum over batch lanes
    of each lane's iteration count) for [X, Z] — the honest work measure
    under early exit (SURVEY §7), including relay retries.

    ``relay_retries > 0``: BP failures are repaired on device by the
    ensemble relay decoder before classification (decoder/relay.py) — the
    pure-device quality mode, shardable like everything else here (OSD, by
    contrast, needs the host and lives in run_monte_carlo_osd)."""
    xe_i, ze_i, sx, sz, res = _sample_and_decode(
        graphs, key, weight, error_probability, cfg, batch, error_model,
        relay_retries, weight_cap=weight_cap)
    counters = classify_batch(i_minus_p, xe_i, ze_i,
                              res.decisions_x.astype(jnp.int32),
                              res.decisions_z.astype(jnp.int32),
                              res.error_code)
    iters = jnp.stack([res.iter_samples_x, res.iter_samples_z])
    return counters, iters


@partial(jax.jit, static_argnames=("graphs", "weight", "cfg", "batch",
                                   "error_model", "relay_retries"))
def mc_chunk(graphs: CodeGraphs, i_minus_p: jnp.ndarray, key: jax.Array,
             weight: int, error_probability, cfg: BPConfig, batch: int,
             error_model: str = "weight", relay_retries: int = 0):
    """Single-device Monte-Carlo chunk."""
    return _chunk_body(graphs, i_minus_p, key, weight, error_probability, cfg,
                       batch, error_model, relay_retries)


def _scan_chunks(graphs, i_minus_p, key, chunk_ids, weight, error_probability,
                 cfg, batch, error_model, relay_retries=0, weight_cap=None):
    """Scan several chunks on device in one dispatch.  Each chunk derives its
    key as fold_in(key, chunk_id) — identical statistics to dispatching the
    chunks one by one, but the per-dispatch host overhead and the counter
    read-back are paid once per scan instead of per chunk."""

    def body(carry, c):
        counters, iters = carry
        ck = jax.random.fold_in(key, c)
        cnt, its = _chunk_body(graphs, i_minus_p, ck, weight,
                               error_probability, cfg, batch, error_model,
                               relay_retries, weight_cap)
        return (counters + cnt, iters + its), None

    init = (jnp.zeros(NUM_COUNTERS, jnp.int32), jnp.zeros(2, jnp.int32))
    (counters, iters), _ = jax.lax.scan(body, init, chunk_ids)
    return counters, iters


_scan_chunks_jit = jax.jit(
    _scan_chunks,
    static_argnames=("graphs", "weight", "cfg", "batch", "error_model",
                     "relay_retries", "weight_cap"))

#: dynamic-weight variant: ``weight`` is a traced operand, so every weight of
#: a sweep reuses ONE compiled program (weight_cap bounds the draw count)
_scan_chunks_dyn_jit = jax.jit(
    _scan_chunks,
    static_argnames=("graphs", "cfg", "batch", "error_model",
                     "relay_retries", "weight_cap"))


def make_sharded_chunk(mesh: Mesh, graphs: CodeGraphs, weight: int,
                       cfg: BPConfig, batch_per_device: int,
                       error_model: str = "weight", relay_retries: int = 0,
                       weight_cap: int | None = None):
    """Build a jitted shard_map chunk group: each data-axis device decodes its
    own sub-batch with its own fold_in key and early-exit loop; counters are
    psum-reduced to a replicated [NUM_COUNTERS] vector (the device analog of
    the reference's ``#pragma omp atomic`` counters).

    The returned function takes ``(i_minus_p, key, error_probability,
    chunk_ids)`` and scans the given chunk ids on device in one
    dispatch (per-chunk key = fold_in(fold_in(key, chunk_id), device_index),
    identical to dispatching them singly).

    ``weight_cap``: dynamic-weight mode — the weight rides as a traced
    operand of ONE memoized compiled program shared by every weight of a
    sweep (the underlying jit is cached on everything BUT the weight)."""
    jitted = _sharded_chunk_program(mesh, graphs, cfg, batch_per_device,
                                    error_model, relay_retries, weight_cap)
    if weight_cap is None:
        # weight baked into the program (sample_weight_w_errors needs a
        # concrete draw count); one program per weight, today's behavior
        def chunk_fn(i_minus_p, key, error_probability, chunk_ids):
            return jitted[weight](i_minus_p, key, error_probability,
                                  chunk_ids, jnp.int32(0))
    else:
        def chunk_fn(i_minus_p, key, error_probability, chunk_ids):
            return jitted(i_minus_p, key, error_probability, chunk_ids,
                          jnp.int32(weight))
    return chunk_fn


@lru_cache(maxsize=64)
def _sharded_chunk_program(mesh, graphs, cfg, batch_per_device, error_model,
                           relay_retries, weight_cap):
    """The memoized jitted shard_map program behind make_sharded_chunk.

    ``weight_cap is None`` returns a dict-like lazily building one program
    per static weight; otherwise ONE program whose last operand is the
    traced weight."""

    def build(static_weight):
        def shard_fn(i_minus_p, key, error_probability, chunk_ids, w32):
            idx = jax.lax.axis_index(DATA_AXIS)
            w = w32 if weight_cap is not None else static_weight

            def body(carry, c):
                counters, iters = carry
                ck = jax.random.fold_in(jax.random.fold_in(key, c), idx)
                cnt, its = _chunk_body(
                    graphs, i_minus_p, ck, w, error_probability, cfg,
                    batch_per_device, error_model, relay_retries,
                    weight_cap)
                return (counters + cnt, iters + its), None

            init = (jnp.zeros(NUM_COUNTERS, jnp.int32),
                    jnp.zeros(2, jnp.int32))
            (counters, iters), _ = jax.lax.scan(body, init, chunk_ids)
            return (jax.lax.psum(counters, DATA_AXIS),
                    jax.lax.psum(iters, DATA_AXIS))

        # check_vma=False: classic shard_map semantics, so the replicated
        # scan carry needs no pcast to the data-varying type its body
        # produces
        mapped = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return jax.jit(mapped)

    if weight_cap is not None:
        return build(None)

    class _PerWeight(dict):
        def __missing__(self, w):
            self[w] = build(w)
            return self[w]

    return _PerWeight()


@partial(jax.jit, static_argnames=("graphs", "weight", "cfg", "batch",
                                   "error_model", "relay_retries", "mesh"))
def mc_chunk_arrays(graphs: CodeGraphs, key: jax.Array, weight: int,
                    error_probability, cfg: BPConfig, batch: int,
                    error_model: str = "weight", relay_retries: int = 0,
                    mesh: Mesh | None = None):
    """Sample + decode one batch, returning the full per-lane arrays
    (errors, syndromes, DecodeResult) instead of classified counters — a
    debugging/analysis entry point (the production quality mode no longer
    round-trips full arrays; see :func:`run_monte_carlo_osd`).
    ``relay_retries > 0`` first repairs BP failures on device with the
    ensemble relay decoder (decoder/relay.py).

    ``mesh``: when given, the sampled error batch is sharding-constrained
    over the mesh's ``data`` axis and GSPMD partitions the whole pipeline
    (every decode op is batch-elementwise or a row reduction) — the sample
    stream derives from ONE key regardless of the mesh, so results are
    BIT-IDENTICAL to the single-device call."""
    xe_i, ze_i, sx, sz, res = _sample_and_decode(
        graphs, key, weight, error_probability, cfg, batch, error_model,
        relay_retries, mesh=mesh)
    # int8 narrowing: these arrays round-trip to the host per chunk
    return (xe_i.astype(jnp.int8), ze_i.astype(jnp.int8),
            sx.astype(jnp.int8), sz.astype(jnp.int8), res)


#: error-code bits that route a lane through host repair
_SYN_BITS = SYNDROME_FAIL_X | SYNDROME_FAIL_Z


def _classify_and_compact(i_minus_p, xe_i, ze_i, sx, sz, res):
    """Device half of the fast quality mode: classify every lane WITHOUT a
    syndrome-fail bit on device, and permute the per-lane arrays so the
    failed lanes sit first (stable order) — the host then fetches only the
    first ``nfail`` columns instead of six full (n x batch) arrays
    (VERDICT r3 #2).  Returns (counters_ok, nfail, bundle) where bundle is
    (xe, ze, sx, sz, dx, dz, soft_x, soft_z, error_code) compacted."""
    ec = res.error_code
    fail = (ec & _SYN_BITS) != 0
    counters = classify_batch(i_minus_p, xe_i, ze_i,
                              res.decisions_x.astype(jnp.int32),
                              res.decisions_z.astype(jnp.int32), ec,
                              valid=~fail)
    # stable sort on the ok-flag: failed lanes first, original order kept
    order = jnp.argsort(jnp.where(fail, 0, 1).astype(jnp.int32), stable=True)

    def take(a, dtype=None):
        if a is None:
            return None
        out = jnp.take(a, order, axis=-1)
        return out if dtype is None else out.astype(dtype)

    bundle = (take(xe_i, jnp.int8), take(ze_i, jnp.int8),
              take(sx, jnp.int8), take(sz, jnp.int8),
              take(res.decisions_x), take(res.decisions_z),
              take(res.soft_x), take(res.soft_z), take(ec))
    return counters, jnp.sum(fail, dtype=jnp.int32), bundle


def make_osd_chunk(graphs: CodeGraphs, weight: int, cfg: BPConfig,
                   batch: int, error_model: str = "weight",
                   relay_retries: int = 0, mesh: Mesh | None = None):
    """Build the device chunk of the fast quality mode.

    The returned function takes ``(i_minus_p, key, error_probability)`` and
    returns ``(counters_ok, iters[2], nfail, bundle)``:
    counters for all non-syndrome-fail lanes (classified on device), honest
    lane-iteration counts, the per-data-shard failed-lane counts
    (shape ``(num_data,)``), and the compacted per-lane bundle whose first
    ``nfail[d]`` columns of each data shard are that shard's failed lanes.

    Sample stream: ONE key per chunk regardless of the mesh (each data
    shard slices its columns of the full-batch draw, and relay gamma draws
    slice the full-batch uniform) — so for the exact decoders the counters
    are BIT-IDENTICAL across mesh shapes, like the r3 GSPMD path, while the
    shard_map structure additionally gives multi-process lane locality.
    """
    if mesh is None:
        def chunk_fn(i_minus_p, key, error_probability):
            return _osd_chunk_single(graphs, i_minus_p, key, weight,
                                     error_probability, cfg, batch,
                                     error_model, relay_retries)
        return chunk_fn
    if dict(mesh.shape).get(GRAPH_AXIS, 1) > 1:
        raise ValueError("graph-sharded quality chunks live in "
                         "parallel/mc_graph.make_graph_sharded_osd_chunk")
    num_data = mesh.shape[DATA_AXIS]
    if batch % num_data != 0:
        raise ValueError(f"batch={batch} must be divisible by the data-axis "
                         f"size {num_data}")
    bpd = batch // num_data
    n = graphs.code.n

    def shard_fn(i_minus_p, key, error_probability):
        didx = jax.lax.axis_index(DATA_AXIS)
        # full global batch from the single chunk key, slice own columns
        if error_model == "weight":
            xe_f, ze_f = sample_weight_w_errors(key, n, weight, batch)
        elif error_model == "depolarizing":
            xe_f, ze_f = sample_depolarizing_errors(key, n,
                                                    error_probability, batch)
        else:
            raise ValueError(f"unknown error model {error_model!r}")
        off = didx * bpd
        xe = jax.lax.dynamic_slice_in_dim(xe_f, off, bpd, axis=1)
        ze = jax.lax.dynamic_slice_in_dim(ze_f, off, bpd, axis=1)
        xe_i, ze_i = xe.astype(jnp.int32), ze.astype(jnp.int32)
        sx = graphs.x.syndrome(xe_i)
        sz = graphs.z.syndrome(ze_i)
        if relay_retries > 0:
            from qec_ldpc.decoder.relay import relay_decode_batch

            relay_key = jax.random.fold_in(key, jnp.uint32(0x52454C41))
            res, _, _ = relay_decode_batch(
                graphs, sx, sz, error_probability, relay_key, cfg,
                retries=relay_retries,
                gamma_lanes=batch, lane_offset=off)
        else:
            res = decode_batch(graphs, sx, sz, error_probability, cfg)
        counters, nfail, bundle = _classify_and_compact(
            i_minus_p, xe_i, ze_i, sx, sz, res)
        iters = jnp.stack([res.iter_samples_x, res.iter_samples_z])
        return (jax.lax.psum(counters, DATA_AXIS),
                jax.lax.psum(iters, DATA_AXIS), nfail[None], bundle)

    bundle_specs = (P(None, DATA_AXIS),) * 8 + (P(DATA_AXIS),)
    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P(), P(DATA_AXIS), bundle_specs),
        check_vma=False,
    )
    return jax.jit(mapped)


@partial(jax.jit, static_argnames=("graphs", "weight", "cfg", "batch",
                                   "error_model", "relay_retries"))
def _osd_chunk_single(graphs, i_minus_p, key, weight, error_probability, cfg,
                      batch, error_model, relay_retries):
    xe_i, ze_i, sx, sz, res = _sample_and_decode(
        graphs, key, weight, error_probability, cfg, batch, error_model,
        relay_retries)
    counters, nfail, bundle = _classify_and_compact(
        i_minus_p, xe_i, ze_i, sx, sz, res)
    iters = jnp.stack([res.iter_samples_x, res.iter_samples_z])
    return counters, iters, nfail[None], bundle


def _gather_failed_lanes(nfail, bundle, owned_starts=None):
    """Fetch ONLY the failed (compacted-first) columns of each locally
    addressable data shard to the host.  Column counts are rounded up to
    powers of two so the on-device slice programs compile O(log batch)
    distinct shapes, not one per count.  Returns a tuple of concatenated
    numpy arrays (order: local shards by global column offset) or None if
    no owned lane failed.

    ``owned_starts``: on a (data x graph) mesh the bundle columns are
    replicated over the graph axis; each process must fetch a data shard
    from exactly ONE replica — the set of global column offsets this
    process owns (None = own everything addressable, dedup'd)."""
    k_by_dev = {s.device: int(np.asarray(s.data)[0])
                for s in nfail.addressable_shards}

    def fetch(arr):
        if arr is None:
            return None
        parts = []
        seen = set()
        for s in sorted(arr.addressable_shards,
                        key=lambda s: s.index[-1].start or 0):
            start = s.index[-1].start or 0
            if start in seen:
                continue  # graph-axis replica of a shard already fetched
            if owned_starts is not None and start not in owned_starts:
                continue  # another process owns this data shard
            seen.add(start)
            k = k_by_dev[s.device]
            if k == 0:
                continue
            kp = 1 << (k - 1).bit_length()
            kp = min(kp, s.data.shape[-1])
            parts.append(np.asarray(s.data[..., :kp])[..., :k])
        if not parts:
            return np.zeros(arr.shape[:-1] + (0,), dtype=arr.dtype)
        return np.concatenate(parts, axis=-1)

    out = tuple(fetch(a) for a in bundle)
    ec = out[-1]
    if ec is None or ec.shape[-1] == 0:
        return None
    return out


def _repair_and_classify_np(post, i_minus_p, failed):
    """Host tail of the quality mode: OSD-repair the fetched failed lanes
    (when ``post`` is set) and classify them with the NumPy mirror; returns
    the failed-lane counter vector (int64)."""
    from qec_ldpc.decoder.decode import DecodeResult
    from qec_ldpc.sampling.classify import classify_batch_np

    xe, ze, sx, sz, dx, dz, softx, softz, ec = failed
    if post is not None:
        res = DecodeResult(
            decisions_x=dx, decisions_z=dz, error_code=ec,
            iters_x=0, iters_z=0, iter_samples_x=0, iter_samples_z=0,
            soft_x=softx, soft_z=softz)
        dx, dz, ec = post.apply(sx, sz, res)
    return classify_batch_np(i_minus_p, xe, ze, dx, dz, ec)


def run_monte_carlo_osd(
    graphs: CodeGraphs,
    weight: int,
    count: int,
    error_probability: float,
    cfg: BPConfig,
    seed: int,
    batch_size: int = 1024,
    lam: int = 0,
    error_model: str = "weight",
    progress: "callable | None" = None,
    relay_retries: int = 0,
    i_minus_p=None,
    mesh: Mesh | None = None,
    start_chunk: int = 0,
    init_counters: np.ndarray | None = None,
):
    """Monte-Carlo statistics with repair of BP failures (the QUALITY mode).

    Same counter contract and per-chunk sample keys as
    :func:`run_monte_carlo` (seed-for-seed identical error draws).  Two
    repair stages, each optional:

    * ``relay_retries > 0`` — on-device ensemble relay (decoder/relay.py):
      randomized damped min-sum retries; repaired lanes are true BP fixed
      points (usually the right logical coset).
    * ``lam >= 0`` — host OSD (decoder/osd.py) on whatever still fails:
      guaranteed syndrome-valid corrections (``lam`` = combination-sweep
      depth).  Algorithm note: LLR-domain soft outputs rank far better than
      saturated sum-product ones — pair OSD with ``algorithm="min-sum"`` or
      ``"layered-min-sum"`` (see decoder/osd.py).

    With both enabled: relay first (device), OSD mops up.  ``lam = -1``
    disables OSD (relay only).  Classification runs on the host (NumPy +
    native GF(2) matvec) since spliced decisions live there anyway; prefer
    :func:`run_monte_carlo` for pure-throughput runs where failures are only
    counted, not repaired.

    Fast path (VERDICT r3 #2): the no-failure path never leaves the device —
    non-failed lanes classify on device (``classify_batch(valid=...)``) and
    only the (rare) failed lanes are fetched, compacted-first, for host
    repair; chunk c+1 is dispatched before chunk c's host tail runs, so the
    device pipeline stays busy.  At low weights this is within noise of the
    counting-only :func:`run_monte_carlo` throughput.

    Scale-out: ``mesh`` runs the device half as a shard_map over the data
    axis with ONE key per chunk, so for the exact decoders
    (min-sum / layered) counters stay BIT-IDENTICAL across mesh shapes;
    iteration TOTALS are partition-dependent (each shard's early-exit loop
    stops on its own lanes).  Multi-process (VERDICT r3 #5): each process
    repairs its locally addressable failed lanes and the per-chunk failed
    counters are all-reduced across processes — counters match the
    single-process run bit-for-bit for the exact decoders.

    ``start_chunk`` / ``init_counters`` resume from a journal of
    POST-repair counters (chunks, not dispatch groups).
    """
    import dataclasses as _dc

    if lam >= 0:
        from qec_ldpc.decoder.osd import CSSPostprocessor

        cfg = _dc.replace(cfg, return_soft=True)
        post = CSSPostprocessor(graphs, lam=lam)
    else:
        post = None
    i_minus_p = _resolve_logical_test(graphs, i_minus_p)
    key = jax.random.PRNGKey(seed)
    num_graph = dict(mesh.shape).get(GRAPH_AXIS, 1) if mesh is not None else 1
    if num_graph > 1:
        # graph-sharded device half (parallel/mc_graph.py): identical sample
        # stream (one key per chunk), decode sharded over the graph axis
        # with soft outputs gathered for the host OSD splice; min-sum
        # decisions/soft bit-match the single-device path.
        from qec_ldpc.parallel.mc_graph import (
            make_graph_sharded_osd_chunk,
        )

        chunk_fn = make_graph_sharded_osd_chunk(
            mesh, graphs, weight, cfg, batch_size, error_model,
            relay_retries)
        # bundle columns are replicated over the graph axis: this process
        # fetches a data shard only when it hosts the shard's graph-row-0
        # replica (exactly-once ownership across processes)
        num_data = mesh.shape[DATA_AXIS]
        bpd = batch_size // num_data
        pid = jax.process_index()
        owned_starts = {
            d * bpd for d in range(num_data)
            if mesh.devices[d, 0].process_index == pid
        }
    else:
        chunk_fn = make_osd_chunk(graphs, weight, cfg, batch_size,
                                  error_model, relay_retries, mesh)
        owned_starts = None  # data-only: column ranges are unreplicated
    multi = jax.process_count() > 1
    if multi:
        # the failed-lane counters are summed with process_allgather below;
        # that is only correct when each process decodes a DISJOINT slice of
        # the batch — i.e. the device half runs as a shard_map over a mesh
        # spanning every process.  With mesh=None (or a mesh missing some
        # process) every process would decode the full batch and failures
        # would be counted once per process (advisor r4 medium).
        if mesh is None:
            raise ValueError(
                "run_monte_carlo_osd with jax.process_count() > 1 requires "
                "a mesh spanning all processes (mesh=None would decode the "
                "full batch on every process and multi-count failures)")
        procs = {d.process_index for d in mesh.devices.flat}
        if len(procs) != jax.process_count():
            raise ValueError(
                f"run_monte_carlo_osd mesh spans processes {sorted(procs)} "
                f"but {jax.process_count()} processes are running; every "
                f"process must own a slice of the mesh or failed-lane "
                f"counters would be multi-counted")
    totals = np.zeros(NUM_COUNTERS, dtype=np.int64)
    if init_counters is not None:
        totals += np.asarray(init_counters, dtype=np.int64)
    total_iters = 0
    num_chunks = -(-count // batch_size)
    p32 = jnp.float32(error_probability)

    def process(item):
        nonlocal totals, total_iters
        c, (counters_ok, iters, nfail, bundle) = item
        failed = _gather_failed_lanes(nfail, bundle, owned_starts)
        if failed is not None:
            cnt_failed = _repair_and_classify_np(post, i_minus_p, failed)
        else:
            cnt_failed = np.zeros(NUM_COUNTERS, dtype=np.int64)
        if multi:
            # every process calls this once per chunk (same order), so the
            # host-side reduction is a well-ordered collective
            from jax.experimental import multihost_utils

            cnt_failed = np.asarray(
                multihost_utils.process_allgather(cnt_failed)
            ).sum(axis=0)
        counters = np.asarray(counters_ok, dtype=np.int64) + cnt_failed
        chunk_iters = int(np.asarray(iters).sum())
        totals += counters
        total_iters += chunk_iters
        if progress is not None:
            progress(c, num_chunks, counters, chunk_iters)

    pending = None
    for c in range(start_chunk, num_chunks):
        ck = jax.random.fold_in(key, np.uint32(c))
        out = chunk_fn(i_minus_p, ck, p32)
        # one-deep pipeline: the device works on chunk c while the host
        # repairs chunk c-1 (JAX async dispatch)
        if pending is not None:
            process(pending)
        pending = (c, out)
    if pending is not None:
        process(pending)
    return totals, total_iters


def _effective_spc(num_chunks: int, steps_per_call: int) -> int:
    """The dispatch-group size actually used for ``num_chunks`` chunks.

    A ragged last group is a SECOND compiled program — prefer the largest
    divisor of num_chunks <= steps_per_call so the whole run is one program
    (unless that collapses the scan depth so far the per-dispatch overhead
    would dominate instead).  Deterministic in (num_chunks, steps_per_call)."""
    if num_chunks % steps_per_call:
        div = next((d for d in range(min(steps_per_call, num_chunks), 0, -1)
                    if num_chunks % d == 0), 1)
        if div >= max(1, steps_per_call // 8):
            steps_per_call = div
    return steps_per_call


def effective_steps_per_call(count: int, batch_size: int, steps_per_call: int,
                             mesh: Mesh | None = None) -> int:
    """The steps_per_call :func:`run_monte_carlo` will ACTUALLY use.

    ``run_monte_carlo`` may silently replace the configured value with a
    divisor of the chunk count (see :func:`_effective_spc`) — which changes
    dispatch-group boundaries, and ``start_chunk`` counts dispatch groups.
    Callers that persist resumable journals (harness/cli.py) must therefore
    pin THIS value (not the configured one) in the journal run_id, so a
    journal written under one grouping is never resumed under another
    (advisor r4 medium: pre-adjustment journals resumed with the divisor
    applied would double-count or skip chunks)."""
    if mesh is not None:
        num_data = mesh.shape[DATA_AXIS]
        chunk_samples = max(1, batch_size // num_data) * num_data
    else:
        chunk_samples = batch_size
    num_chunks = -(-count // chunk_samples)
    return _effective_spc(num_chunks, steps_per_call)


def run_monte_carlo(
    graphs: CodeGraphs,
    weight: int,
    count: int,
    error_probability: float,
    cfg: BPConfig,
    seed: int,
    batch_size: int = 1024,
    mesh: Mesh | None = None,
    error_model: str = "weight",
    progress: "callable | None" = None,
    start_chunk: int = 0,
    init_counters: np.ndarray | None = None,
    steps_per_call: int = 1,
    relay_retries: int = 0,
    i_minus_p=None,
    weight_cap: int | None = None,
):
    """Accumulate statistics counters over ``count`` samples.

    Chunks of ``batch_size`` samples run until >= count samples are tested
    (count is rounded up to a whole number of chunks, mirroring the
    reference's COUNT/nThreads rounding, DecoderCPU.h:427,438,527).

    ``steps_per_call`` chunks are scanned on device per dispatch — identical
    statistics (per-chunk keys derive from the global chunk index), but the
    per-dispatch runtime overhead is amortized; progress/journal granularity
    becomes one record per dispatch group, so resume requires the same
    (batch_size, steps_per_call).

    ``start_chunk``/``init_counters`` support journal-based resume
    (harness/journal.py); ``start_chunk`` counts dispatch groups.
    ``relay_retries > 0`` repairs BP failures on device with the ensemble
    relay decoder before classification (decoder/relay.py) — quality mode
    that stays pure-device, so it composes with meshes, scans, and resume.
    Returns (counters[NUM_COUNTERS], total_bp_iters) where total_bp_iters
    counts executed BP lane-iterations (X + Z) across all samples.

    ``i_minus_p``: the logical-test operand — a dense (2n x 2n) matrix or a
    :class:`~qec_ldpc.sampling.classify.RankBasisTest` (bit-identical
    classification at O(rank * n) memory).  Defaults to the rank-basis test
    of ``graphs.code`` in the reference convention.

    ``weight_cap`` (weight model, data-parallel/single-device paths): make
    ``weight`` a RUNTIME value so every weight of a sweep shares ONE
    compiled program — the reference's own w..W sweep pattern compiles
    once instead of once per weight.  The
    sample stream differs from the static sampler (identical at
    ``weight == weight_cap``); graph-sharded paths ignore it (per-weight
    programs there).
    """
    i_minus_p = _resolve_logical_test(graphs, i_minus_p)
    key = jax.random.PRNGKey(seed)
    if mesh is not None:
        num_data = mesh.shape[DATA_AXIS]
        num_graph = dict(mesh.shape).get(GRAPH_AXIS, 1)
        per_dev = max(1, batch_size // num_data)
        if num_graph > 1:
            # (data x graph) mesh: decode itself is sharded over the graph
            # axis (parallel/mc_graph.py) — BASELINE config 5 end-to-end
            from qec_ldpc.parallel.mc_graph import make_graph_sharded_chunk

            chunk_fn = make_graph_sharded_chunk(
                mesh, graphs, weight, cfg, per_dev, error_model,
                relay_retries)
        else:
            chunk_fn = make_sharded_chunk(mesh, graphs, weight, cfg, per_dev,
                                          error_model, relay_retries,
                                          weight_cap=weight_cap)
        chunk_samples = per_dev * num_data

        def run_group(ids, p):
            return chunk_fn(i_minus_p, key, jnp.float32(p), ids)
    else:
        chunk_samples = batch_size
        if weight_cap is not None:
            def run_group(ids, p):
                return _scan_chunks_dyn_jit(
                    graphs, i_minus_p, key, ids, jnp.int32(weight),
                    jnp.float32(p), cfg, batch_size, error_model,
                    relay_retries, weight_cap)
        else:
            def run_group(ids, p):
                return _scan_chunks_jit(graphs, i_minus_p, key, ids, weight,
                                        jnp.float32(p), cfg, batch_size,
                                        error_model, relay_retries)

    totals = np.zeros(NUM_COUNTERS, dtype=np.int64)
    if init_counters is not None:
        totals += np.asarray(init_counters, dtype=np.int64)
    total_iters = 0
    num_chunks = -(-count // chunk_samples)
    # group-size adjustment shared with effective_steps_per_call so journal
    # run_ids can pin the ACTUAL dispatch-group boundaries (advisor r4)
    steps_per_call = _effective_spc(num_chunks, steps_per_call)
    group_ids = [np.arange(g, min(g + steps_per_call, num_chunks),
                           dtype=np.uint32)
                 for g in range(0, num_chunks, steps_per_call)]
    for gi in range(start_chunk, len(group_ids)):
        ids = jnp.asarray(group_ids[gi])
        counters, iters = run_group(ids, error_probability)
        counters = np.asarray(counters, dtype=np.int64)
        chunk_iters = int(np.asarray(iters).sum())
        total_iters += chunk_iters
        totals += counters
        if progress is not None:
            progress(gi, len(group_ids), counters, chunk_iters)
    return totals, total_iters
