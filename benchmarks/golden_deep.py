"""Deep-statistics count parity vs the [[610,61]] golden corpus.

VERDICT r3 #1: the north-star's "logical-error parity" clause is only proven
at shallow depth by ``golden_sweep.py`` (10 240 samples/point — zero logical
errors observed at W <= 19, so the reference's headline 1-in-100 000 LER
point, ``results/...[[n=610,k=61]]_W_15_MAX_100_p_0.01.txt``, was untested).
This benchmark decodes >= 1M samples at every corpus weight the VERDICT
names (W in {15, 20, 25, 30, 40, 50, 58}, MAX=100) with plain sum-product —
the reference decoder family, no relay/OSD — and compares EVERY rare-event
counter (logical errors, convergence-fail X/Z per ``DecoderCPU.h:514-521``,
syndrome-fail X/Z) by exact conditional-binomial two-sample tests, plus the
corrected-fraction z-score.

Prior provenance (round-2 finding, golden_sweep.py note): the reference's
p_0.01-labeled [[610]] runs were generated with prior p=0.02, so the
apples-to-apples comparison decodes at 0.02; records carry BOTH priors.

Usage (on the GPU):
    python -m benchmarks.golden_deep [out.jsonl] [samples_per_point]
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

WEIGHTS = (15, 20, 25, 30, 40, 50, 58)
MAX_ITERS = 100


def _log_binom_pmf(k: int, n: int, p: float) -> float:
    if p <= 0.0:
        return 0.0 if k == 0 else -math.inf
    if p >= 1.0:
        return 0.0 if k == n else -math.inf
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
            + k * math.log(p) + (n - k) * math.log1p(-p))


def binom_test_two_sided(k: int, n: int, p: float) -> float:
    """Exact two-sided binomial test (sum of outcomes no more likely than k),
    the classic "minlike" definition.  n here is small-ish (<= total event
    count across both sides), so the O(n) sum is fine."""
    if n == 0:
        return 1.0
    lp_k = _log_binom_pmf(k, n, p)
    tot = 0.0
    for j in range(n + 1):
        lp = _log_binom_pmf(j, n, p)
        if lp <= lp_k + 1e-9:
            tot += math.exp(lp)
    return min(1.0, tot)


def rate_parity_pvalue(k_ref: int, n_ref: int, k_ours: int, n_ours: int) -> float:
    """Two-sample rate comparison: under H0 (same Poisson/binomial rate),
    k_ref | (k_ref + k_ours) ~ Binomial(k_ref + k_ours, n_ref/(n_ref+n_ours)).
    Exact, valid for arbitrarily small counts (the regime this artifact
    exists for: 1 logical error in 100 000 reference samples)."""
    total = k_ref + k_ours
    return binom_test_two_sided(k_ref, total, n_ref / (n_ref + n_ours))


def poisson_ci(k: int, alpha: float = 0.05) -> tuple[float, float]:
    """Exact (Garwood) Poisson CI for an event count, via the chi-square /
    gamma duality; used to report rate intervals alongside the tests."""
    from math import inf

    def gamma_ppf(q, shape):
        # bisection on the regularized lower incomplete gamma
        if shape <= 0:
            return 0.0
        lo, hi = 0.0, shape + 10 * math.sqrt(shape) + 10
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if _reg_gamma_lower(shape, mid) < q:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    lo = gamma_ppf(alpha / 2, k) if k > 0 else 0.0
    hi = gamma_ppf(1 - alpha / 2, k + 1)
    return lo, hi if hi != inf else inf


def _reg_gamma_lower(s: float, x: float) -> float:
    """Regularized lower incomplete gamma P(s, x) by series/continued
    fraction (Numerical-Recipes-style; plenty accurate for CI bisection)."""
    if x <= 0:
        return 0.0
    if x < s + 1:
        term = 1.0 / s
        total = term
        a = s
        for _ in range(500):
            a += 1
            term *= x / a
            total += term
            if term < total * 1e-12:
                break
        return total * math.exp(-x + s * math.log(x) - math.lgamma(s))
    # continued fraction for Q(s,x), P = 1 - Q
    b = x + 1 - s
    c = 1e300
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - s)
        b += 2
        d = an * d + b
        d = 1.0 / (d if abs(d) > 1e-300 else 1e-300)
        c = b + an / c
        c = c if abs(c) > 1e-300 else 1e-300
        de = d * c
        h *= de
        if abs(de - 1.0) < 1e-12:
            break
    q = h * math.exp(-x + s * math.log(x) - math.lgamma(s))
    return 1.0 - q


#: the reference's single deepest run — 100 000 samples, 1 logical error —
#: the north-star's headline LER evidence (VERDICT r3 #1)
HEADLINE_W15 = ("/root/reference/QEC_LDPC/results/"
                "[J=4,K=5,L=10,P=61,s=9,t=49][[n=610,k=61]]"
                "_W_15_MAX_100_p_0.01.txt")


def read_deep_points():
    """[(weight, ref_record)] for the VERDICT-named weights from the
    p=0.01-labeled corpus files; W=15 uses the 100 000-sample headline file
    at the results root (the subdir file holds only 10 000 samples)."""
    from qec_ldpc.harness import parse_reference_text

    from benchmarks.golden_sweep import read_golden_points

    by_key = {(w, m, p): rec for w, m, p, rec in read_golden_points()}
    by_key[(15, MAX_ITERS, 0.01)] = parse_reference_text(
        open(HEADLINE_W15).read())[0]
    return [(w, by_key[(w, MAX_ITERS, 0.01)]) for w in WEIGHTS]


def main(out_path: str = "benchmarks/data/golden_deep_r4.jsonl",
         samples_per_point: str = str(2048 * 512)) -> int:
    import jax

    from benchmarks.common import setup_jax_cache

    setup_jax_cache()

    from functools import partial

    import jax.numpy as jnp

    from qec_ldpc.codes import construct_code
    from qec_ldpc.decoder import BPConfig, CodeGraphs
    from qec_ldpc.decoder.decode import decode_batch
    from qec_ldpc.sampling import (
        NUM_COUNTERS,
        classify_batch,
        sample_weight_w_errors_dynamic,
    )
    from qec_ldpc.sampling.classify import make_rank_basis_test

    count = int(samples_per_point)
    code = construct_code(4, 5, 10, 61, 9, 49)
    graphs = CodeGraphs.build(code)
    ltest = make_rank_basis_test(code)
    W_MAX = 64
    batch = 2048
    num_chunks = -(-count // batch)
    cfg = BPConfig(max_iters=MAX_ITERS)

    # one compiled program for the whole artifact: weight and prior are
    # runtime values (dynamic sampler), counters accumulate int64 on device
    @partial(jax.jit, static_argnames=("cfg", "batch", "num_chunks"))
    def deep_point(lt, key, weight, p, cfg, batch, num_chunks):
        def body(counters, c):
            ck = jax.random.fold_in(key, c)
            xe, ze = sample_weight_w_errors_dynamic(
                ck, graphs.code.n, weight, W_MAX, batch)
            xe_i, ze_i = xe.astype(jnp.int32), ze.astype(jnp.int32)
            sx = graphs.x.syndrome(xe_i)
            sz = graphs.z.syndrome(ze_i)
            res = decode_batch(graphs, sx, sz, p, cfg)
            cnt = classify_batch(lt, xe_i, ze_i,
                                 res.decisions_x.astype(jnp.int32),
                                 res.decisions_z.astype(jnp.int32),
                                 res.error_code)
            return counters + cnt, None

        # int32 is safe: counts top out at samples_per_point (~1M) << 2^31
        init = jnp.zeros(NUM_COUNTERS, jnp.int32)
        counters, _ = jax.lax.scan(
            body, init, jnp.arange(num_chunks, dtype=jnp.uint32))
        return counters

    points = read_deep_points()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    t_all = time.perf_counter()
    records = []
    for i, (w, ref) in enumerate(points):
        n_ref = int(ref["Errors Tested"])
        refc = {
            "corrected": int(ref["Corrected"]),
            "logical": int(ref["Logical Errors"]),
            "syn_x": int(ref["Syndrome Errors X"]),
            "syn_z": int(ref["Syndrome Errors Z"]),
            "conv_x": int(ref["Convergence Fail X"]),
            "conv_z": int(ref["Convergence Fail Z"]),
        }
        rec = {"weight": w, "max_iters": MAX_ITERS, "p_label": 0.01,
               "ref_tested": n_ref, **{f"ref_{k}": v for k, v in refc.items()}}
        for prior, tag in ((0.02, ""), (0.01, "_prior001")):
            t0 = time.perf_counter()
            counters = np.asarray(deep_point(
                ltest, jax.random.PRNGKey(7000 + w), jnp.int32(w),
                jnp.float32(prior), cfg, batch, num_chunks))
            dt = time.perf_counter() - t0
            n_ours = int(counters[0])
            ours = {
                "corrected": int(counters[3]),
                "logical": int(counters[6]),
                "syn_x": int(counters[4]),
                "syn_z": int(counters[5]),
                "conv_x": int(counters[7]),
                "conv_z": int(counters[8]),
            }
            side = {"ours_tested": n_ours, "seconds": round(dt, 2)}
            for k, v in ours.items():
                side[f"ours_{k}"] = v
            # corrected-fraction z (binomial, both sides' noise)
            pr = refc["corrected"] / n_ref
            po = ours["corrected"] / n_ours
            sigma = math.sqrt(pr * (1 - pr) / n_ref
                              + po * (1 - po) / n_ours) or 1e-9
            side["z_corrected"] = round((po - pr) / sigma, 3)
            # exact two-sample rate tests for every rare-event counter
            for k in ("logical", "syn_x", "syn_z", "conv_x", "conv_z"):
                side[f"pvalue_{k}"] = round(
                    rate_parity_pvalue(refc[k], n_ref, ours[k], n_ours), 6)
            lo, hi = poisson_ci(ours["logical"])
            side["ours_logical_rate"] = ours["logical"] / n_ours
            side["ours_logical_rate_ci95"] = [lo / n_ours, hi / n_ours]
            side["ref_logical_rate"] = refc["logical"] / n_ref
            rec.update({k + tag: v for k, v in side.items()})
            print(f"[{i + 1}/{len(points)}] W={w} prior={prior}: "
                  f"corrected z={side['z_corrected']:+.2f} "
                  f"logical {ours['logical']}/{n_ours} "
                  f"(ref {refc['logical']}/{n_ref}, "
                  f"p={side['pvalue_logical']:.3f}) "
                  f"conv_x p={side['pvalue_conv_x']:.3f} ({dt:.1f}s)",
                  flush=True)
        records.append(rec)

    with open(out_path, "w") as f:
        meta = {
            "artifact": "golden_deep", "code": str(code),
            "decoder": "sum-product",
            "samples_per_point": count,
            "device_kind": jax.devices()[0].device_kind,
            "points": len(records),
            "total_seconds": round(time.perf_counter() - t_all, 1),
            "note": ("deep (>= 1M samples/point) count parity vs the "
                     "reference's deepest [[610]] corpus files; unsuffixed "
                     "fields decode at prior 0.02, _prior001 fields at "
                     "0.01; pvalue_* are exact conditional binomial "
                     "two-sample rate tests (DecoderCPU.h:514-521 conv-fail "
                     "curve; the W=15 file's 1e-5 logical rate).  REFINED "
                     "PROVENANCE (this artifact's own data): the W>=20 "
                     "subdir corpus files match prior 0.02 (the round-2 "
                     "finding), but the 100k-sample W=15 HEADLINE file at "
                     "the results root matches prior 0.01 (z=+0.27 at 0.01 "
                     "vs z=+10.2 at 0.02) — gate W=15 on _prior001 fields "
                     "and W>=20 on the unsuffixed ones (bench.py's "
                     "prior-0.01 headline gate is therefore correct)"),
        }
        f.write(json.dumps(meta) + "\n")
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
