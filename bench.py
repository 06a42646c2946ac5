"""Benchmark: batched dense random LPs on one GPU vs single-core HiGHS.

Prints ONE JSON line per run:
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

``vs_baseline`` is LPs/sec on the device divided by single-core HiGHS
LPs/sec on the same instance distribution (context, not the metric).
Instances are generated ON DEVICE (only a PRNG key crosses the host<->device
link); a sample is read back and cross-checked against the HiGHS oracle.
Extra keys document pivots/sec, correctness, lane-status counts and the
per-family legs.  Every result names the device it ran on; without a GPU
the script exits non-zero.
"""

import argparse
import json
import sys
import time

import numpy as np


def _efficiency(total_iters, wall, flops_per_iter):
    """Per-family efficiency block: us per lane-iteration and the
    sustained TFLOP/s a documented per-iteration FLOP model implies."""
    if wall <= 0 or total_iters <= 0:
        return None
    tf = total_iters * flops_per_iter / wall / 1e12
    return {
        "us_per_lane_iter": round(1e6 * wall / total_iters, 3),
        "est_tflops": round(tf, 4),
    }


def _device_info(jax):
    """Platform, kind and count as JAX reports them, plus nvidia-smi's
    name and power limit of the cards."""
    from chip_smoke import nvidia_smi_line

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": nvidia_smi_line()}


def run_size(jax, m, n, chunk, chunks, maxiters, cfg, highs_samples):
    from linprog_tpu.batch import batch_summary, solve_batch_two_phase
    from linprog_tpu.generators import (
        device_inequality_lps,
        device_standard_form_batch,
    )

    @jax.jit
    def gen(key):
        c, G, h = device_inequality_lps(key, chunk, m, n)
        cs, As, bs = device_standard_form_batch(c, G, h)
        return (c, G, h), (cs, As, bs)

    def run(key):
        (c, G, h), (cs, As, bs) = gen(key)
        res = solve_batch_two_phase(cs, As, bs, maxiters, maxiters, cfg)
        return (c, G, h), res

    keys = jax.random.split(jax.random.PRNGKey(0), chunks)

    # warm-up/compile (excluded from timing)
    (c0, G0, h0), res0 = run(keys[0])
    first_costs = np.asarray(res0.cost)

    t0 = time.time()
    total_pivots = 0
    statuses = []
    results = [run(k) for k in keys]  # async dispatch chain
    for _, res in results:
        s = batch_summary(res)  # forces the device result
        total_pivots += s["total_pivots"]
        statuses.append(s)
    wall = time.time() - t0
    total_lps = chunks * chunk
    lps_per_sec = total_lps / wall
    pivots_per_sec = total_pivots / wall

    # single-core HiGHS baseline on a readback sample of the distribution
    try:
        from scipy.optimize import linprog as scipy_linprog

        k = highs_samples
        c_s = np.asarray(c0[:k])
        G_s = np.asarray(G0[:k])
        h_s = np.asarray(h0[:k])
        gaps = []
        times = []
        for i in range(k):
            t0 = time.time()
            ref = scipy_linprog(
                c_s[i], A_ub=G_s[i], b_ub=h_s[i], bounds=(0, None),
                method="highs",
            )
            times.append(time.time() - t0)
            if ref.status == 0:
                gaps.append(
                    abs(float(first_costs[i]) - ref.fun) / max(1.0, abs(ref.fun))
                )
        # median, not mean: single-core HiGHS timing varies ~2x with
        # machine load, and the headline multiplier inherited that noise
        highs_sec_per_lp = float(np.median(times))
        highs_lps = 1.0 / highs_sec_per_lp
        max_gap = max(gaps) if gaps else float("nan")
    except Exception:  # scipy unavailable: no baseline ratio
        highs_lps = float("nan")
        max_gap = float("nan")

    agg = {
        "optimal": sum(s["optimal"] for s in statuses),
        "infeasible": sum(s["infeasible"] for s in statuses),
        "unbounded": sum(s["unbounded"] for s in statuses),
        "iter_limit": sum(s["iter_limit"] for s in statuses),
        "numerical_error": sum(s.get("numerical_error", 0) for s in statuses),
    }
    vs_baseline = (
        lps_per_sec / highs_lps if np.isfinite(highs_lps) else float("nan")
    )
    # simplex per-pivot FLOP model: pricing y'A over the n+2m two-phase
    # columns (2*m*(n+2m)) + duals/direction/eta rank-1 update (~6*m^2)
    flops_per_pivot = 2 * m * (n + 2 * m) + 6 * m * m
    return {
        "lps_per_sec": round(lps_per_sec, 2),
        "vs_baseline": round(vs_baseline, 2),
        "pivots_per_sec": round(pivots_per_sec, 1),
        "total_lps": total_lps,
        "wall_sec": round(wall, 3),
        "highs_single_core_lps_per_sec": round(highs_lps, 4),
        "max_rel_gap_vs_highs": float(f"{max_gap:.3e}"),
        "lane_status": agg,
        "efficiency": _efficiency(total_pivots, wall, flops_per_pivot),
    }


def run_exact_head(jax, m, n, chunk, chunks, highs_samples):
    """Headline: the EXACT pipeline at m=n=256.

    The inverse-factor IPM + dual-then-primal crossover (+ two-phase
    simplex fallback for any uncrossed lane); the pure simplex pipeline
    on the same workload is kept as the `simplex_m256` extra."""
    import jax.numpy as jnp

    from linprog_tpu import status as stt
    from linprog_tpu.batch import solve_batch_two_phase
    from linprog_tpu.config import tuned_config
    from linprog_tpu.crossover import ipm_crossover_batch_canonical
    from linprog_tpu.generators import (
        device_inequality_lps,
        device_standard_form_batch,
    )

    cfg = tuned_config(m)

    @jax.jit
    def gen(key):
        return device_inequality_lps(key, chunk, m, n)

    def solve(key):
        c, G, h = gen(key)
        res, crossed = ipm_crossover_batch_canonical(
            c, G, h, crossover_maxiters=512, cfg=cfg
        )
        return (c, G, h), res, crossed

    keys = jax.random.split(jax.random.PRNGKey(0), chunks)

    # warm-up/compile; also pre-warm the 8-lane two-phase fallback bucket
    # so a rare uncrossed lane in a later chunk cannot compile mid-timing
    (c0, G0, h0), res0, crossed0 = solve(keys[0])
    first_costs = np.asarray(res0.cost)
    cs8, As8, bs8 = device_standard_form_batch(c0[:8], G0[:8], h0[:8])
    solve_batch_two_phase(cs8, As8, bs8, 4 * m, 4 * m, cfg)

    t0 = time.time()
    # async dispatch chain: all chunks queue on the device before the
    # first host readback (same pipelining as the simplex run_size)
    results = [solve(k) for k in keys]
    total_iters = 0
    agg = {"optimal": 0, "infeasible": 0, "unbounded": 0, "iter_limit": 0,
           "numerical_error": 0}
    crossed_total = 0
    fallback_total = 0
    fallbacks = []
    for (c, G, h), res, crossed in results:
        crossed_np = np.asarray(crossed)
        s = np.array(res.status)
        bad = np.flatnonzero(~crossed_np)
        if bad.size:  # exact two-phase fallback for uncrossed lanes
            bucket = min(max(8, 1 << int(bad.size - 1).bit_length()), chunk)
            idx = np.resize(bad, bucket)
            csf, Asf, bsf = device_standard_form_batch(
                jnp.take(c, idx, axis=0), jnp.take(G, idx, axis=0),
                jnp.take(h, idx, axis=0),
            )
            sub = solve_batch_two_phase(csf, Asf, bsf, 4 * m, 4 * m, cfg)
            sub_s = np.asarray(sub.status)
            for kk, lane in enumerate(idx):
                s[lane] = sub_s[kk]
            fallback_total += int(bad.size)
            fallbacks.append(((c, G, h), idx, bad, sub))
        agg["optimal"] += int((s == stt.OPTIMAL).sum())
        agg["infeasible"] += int((s == stt.PRIMAL_INFEASIBLE).sum())
        agg["unbounded"] += int((s == stt.PRIMAL_UNBOUNDED).sum())
        agg["iter_limit"] += int((s == stt.ITER_LIMIT).sum())
        agg["numerical_error"] += int((s == stt.NUMERICAL_ERROR).sum())
        total_iters += int(np.asarray(res.iters).sum())
        crossed_total += int(crossed_np.sum())
    wall = time.time() - t0

    # oracle-free evidence for EVERY headline lane (outside the timed
    # wall): dd-accuracy KKT verification of each returned basis --
    # crossed lanes from the pipeline result, fallback lanes from the
    # two-phase sub-result's basis (same slack-extended convention)
    t1 = time.time()
    certified_total = 0
    worst = 0.0
    cert_error = None
    from linprog_tpu.certify import certify_vertex_batch

    for (c, G, h), res, crossed in results:
        try:
            cert = certify_vertex_batch(c, G, h, res.basis)
            ok = np.asarray(cert["certified"]) & np.asarray(crossed)
            certified_total += int(ok.sum())
            if ok.any():
                worst = max(worst, float(
                    np.asarray(cert["primal_residual"])[ok].max()
                ), float(np.asarray(cert["gap"])[ok].max()))
        except Exception as e:  # keep the leg alive; record the cause
            cert_error = f"{type(e).__name__}: {e}"[:200]
    for (c, G, h), idx, bad, sub in fallbacks:
        try:
            cert = certify_vertex_batch(
                jnp.take(c, jnp.asarray(idx), axis=0),
                jnp.take(G, jnp.asarray(idx), axis=0),
                jnp.take(h, jnp.asarray(idx), axis=0),
                sub.basis,
            )
            okf = np.asarray(cert["certified"])
            seen = set()
            for kk, lane in enumerate(idx):
                if lane in bad and lane not in seen and okf[kk]:
                    certified_total += 1
                    seen.add(lane)
        except Exception as e:
            cert_error = f"{type(e).__name__}: {e}"[:200]
    cert_wall = time.time() - t1
    total_lps = chunks * chunk
    lps_per_sec = total_lps / wall

    try:
        from scipy.optimize import linprog as scipy_linprog

        gaps, times = [], []
        c_s = np.asarray(c0[:highs_samples])
        G_s = np.asarray(G0[:highs_samples])
        h_s = np.asarray(h0[:highs_samples])
        for i in range(highs_samples):
            t1 = time.time()
            ref = scipy_linprog(c_s[i], A_ub=G_s[i], b_ub=h_s[i],
                                bounds=(0, None), method="highs")
            times.append(time.time() - t1)
            if ref.status == 0:
                gaps.append(
                    abs(float(first_costs[i]) - ref.fun)
                    / max(1.0, abs(ref.fun))
                )
        highs_lps = 1.0 / float(np.median(times))
        max_gap = max(gaps) if gaps else float("nan")
    except Exception:
        highs_lps = float("nan")
        max_gap = float("nan")

    return {
        "lps_per_sec": round(lps_per_sec, 2),
        "vs_baseline": round(lps_per_sec / highs_lps, 2)
        if np.isfinite(highs_lps) else float("nan"),
        "iters_per_sec": round(total_iters / wall, 1),
        "total_lps": total_lps,
        "wall_sec": round(wall, 3),
        "highs_single_core_lps_per_sec": round(highs_lps, 4),
        "max_rel_gap_vs_highs": float(f"{max_gap:.3e}"),
        "lane_status": agg,
        "crossed": crossed_total,
        "fallback": fallback_total,
        "certified": certified_total,
        "max_kkt_residual": (float(f"{worst:.3e}")
                             if certified_total else None),
        "cert_wall_sec": round(cert_wall, 3),
        "cert_error": cert_error,
        "family": "ipm+crossover(+simplex fallback)",
        # res.iters mixes IPM Newton steps and crossover pivots; grading
        # every iteration with the cheaper pivot FLOP model makes this a
        # LOWER bound on the sustained rate
        "efficiency": _efficiency(
            total_iters, wall, 2 * m * (n + m) + 6 * m * m
        ),
    }


def run_bounded(jax, m, n, chunk, maxiters, cfg, highs_samples):
    """Bounded-variable engine datapoint."""
    import jax.numpy as jnp

    from linprog_tpu import bounded as bnd
    from linprog_tpu.batch import solve_batch_bounded
    from linprog_tpu.generators import device_bounded_lps

    @jax.jit
    def gen(key):
        return device_bounded_lps(key, chunk, m, n)

    c, A, b, lb, ub = gen(jax.random.PRNGKey(0))
    B = c.shape[0]
    basis = jnp.broadcast_to(
        jnp.arange(n, n + m, dtype=jnp.int32), (B, m)
    )
    var_state = jnp.concatenate(
        [jnp.zeros((B, n), jnp.int8),
         jnp.full((B, m), int(bnd.BASIC), jnp.int8)], axis=1
    )

    def solve():
        return solve_batch_bounded(
            c, A, b, lb, ub, basis, var_state, maxiters, cfg
        )

    res = solve()  # compile + warm
    np.asarray(res.cost)
    t0 = time.time()
    res = solve()
    costs = np.asarray(res.cost)
    wall = time.time() - t0
    status = np.asarray(res.status)

    gaps = []
    try:
        from scipy.optimize import linprog as scipy_linprog

        for i in range(highs_samples):
            bounds = list(zip(
                np.zeros(n + m),
                [float(u) if np.isfinite(u) else None
                 for u in np.asarray(ub[i])],
            ))
            ref = scipy_linprog(
                np.asarray(c[i]), A_eq=np.asarray(A[i]),
                b_eq=np.asarray(b[i]), bounds=bounds, method="highs",
            )
            if ref.status == 0:
                gaps.append(abs(float(costs[i]) - ref.fun) / max(1, abs(ref.fun)))
    except Exception:
        pass
    return {
        "lps_per_sec": round(B / wall, 2),
        "wall_sec": round(wall, 3),
        "optimal": int((status == 1).sum()),
        "lanes": int(B),
        "max_rel_gap_vs_highs": float(f"{max(gaps):.3e}") if gaps else None,
    }


def run_warm_start(jax, m, n, chunk, maxiters, cfg):
    """Warm-started RHS re-optimization datapoint (dual simplex)."""
    import jax.numpy as jnp

    from linprog_tpu.batch import (
        batch_summary,
        reoptimize_batch_new_rhs,
        solve_batch_two_phase,
    )
    from linprog_tpu.generators import (
        device_inequality_lps,
        device_standard_form_batch,
    )

    @jax.jit
    def gen(key):
        c, G, h = device_inequality_lps(key, chunk, m, n)
        cs, As, bs = device_standard_form_batch(c, G, h)
        kb = jax.random.fold_in(key, 1)
        noise = 1.0 + 0.05 * jax.random.normal(kb, bs.shape, bs.dtype)
        return cs, As, bs, bs * noise

    cs, As, bs, bs_new = gen(jax.random.PRNGKey(3))
    base = solve_batch_two_phase(cs, As, bs, maxiters, maxiters, cfg)
    s_base = batch_summary(base)

    def warm():
        return reoptimize_batch_new_rhs(cs, As, bs_new, base.basis,
                                        maxiters, cfg)

    r = warm()  # compile + warm
    np.asarray(r.cost)
    t0 = time.time()
    r = warm()
    s = batch_summary(r)
    wall = time.time() - t0
    return {
        "lps_per_sec": round(chunk / wall, 2),
        "wall_sec": round(wall, 3),
        "optimal": s["optimal"],
        "lanes": chunk,
        "mean_warm_iters": round(s["total_pivots"] / chunk, 1),
        "mean_fresh_iters": round(s_base["total_pivots"] / chunk, 1),
    }


def run_pdhg_batch(jax, m, n, chunk):
    """First-order family datapoint: batched PDHG at eps 1e-4.

    Fixed-cadence restarts (lockstep batches; the adaptive/Halpern
    variants trade throughput for certificates / fewer iterations -- see
    docs/DESIGN.md)."""
    from linprog_tpu import status as stt
    from linprog_tpu.generators import device_inequality_lps
    from linprog_tpu.pdhg import PDHGConfig, pdhg_solve_batch_canonical

    c, G, h = device_inequality_lps(jax.random.PRNGKey(0), chunk, m, n)
    cfg = PDHGConfig(eps_rel=1e-4, adaptive=False)
    x, cost, status, iters = pdhg_solve_batch_canonical(
        c, G, h, maxiters=60_000, cfg=cfg)
    np.asarray(cost)
    t0 = time.time()
    x, cost, status, iters = pdhg_solve_batch_canonical(
        c, G, h, maxiters=60_000, cfg=cfg)
    ns = int((np.asarray(status) == stt.OPTIMAL).sum())
    wall = time.time() - t0
    return {
        "lps_per_sec": round(chunk / wall, 2),
        "wall_sec": round(wall, 3),
        "optimal": ns,
        "lanes": chunk,
        "median_iters": int(np.median(np.asarray(iters))),
        "eps_rel": 1e-4,
    }


def run_ipm_batch(jax, m, n, chunk, chunks=4):
    """Interior-point family datapoint: batched Mehrotra at f32 eps 1e-3.

    Per iteration: two [B,m,n+m] matmuls + a batched Cholesky.
    6-12 Newton steps per lane regardless of size (vs hundreds of pivots),
    at the f32 normal-equations accuracy floor (~6e-4 KKT; chain
    linprog_tpu.crossover for exact vertices).

    The recovered leg dispatches ``chunks`` raw IPM batches
    asynchronously, then repairs the stragglers from ALL of them in ONE
    pooled crossover (``ipm.recover_stragglers_pooled``): pooling
    amortizes the pivot-loop overhead across every chunk."""
    from linprog_tpu import status as stt
    from linprog_tpu.generators import device_inequality_lps
    from linprog_tpu.ipm import (
        IPMConfig,
        ipm_solve_batch_canonical,
        recover_stragglers_pooled,
    )

    keys = jax.random.split(jax.random.PRNGKey(0), chunks)
    gen = jax.jit(lambda k: device_inequality_lps(k, chunk, m, n))
    batches = [gen(k) for k in keys]
    cfg = IPMConfig(eps_rel=1e-3, maxiters=40, dtype="float32")
    # raw leg: warm (compile), then all chunks timed as one dispatch chain
    raw0 = ipm_solve_batch_canonical(*batches[0], cfg)
    np.asarray(raw0.cost)
    t0 = time.time()
    raws = [ipm_solve_batch_canonical(*b, cfg) for b in batches]
    raw_optimal = sum(
        int((np.asarray(r.status) == stt.OPTIMAL).sum()) for r in raws
    )
    raw_wall = time.time() - t0
    # recovered leg: same dispatch chain + ONE pooled crossover over the
    # stragglers of every chunk (same keys -> same stragglers, so this
    # warm-up covers the recovery bucket's compile too)
    recover_stragglers_pooled(batches, raws)
    t0 = time.time()
    raws = [ipm_solve_batch_canonical(*b, cfg) for b in batches]
    recs = recover_stragglers_pooled(batches, raws)
    ns = sum(
        int((np.asarray(r.status) == stt.OPTIMAL).sum()) for r in recs
    )
    wall = time.time() - t0
    # IPM per-Newton-iteration FLOP model (slack-structured canonical
    # path): normal matrix G Dg G' (2*m*n*m) + inverse-Cholesky factor
    # (~2*m^3 in matmul form) -- the matvec/solve chain is O(m^2) noise
    total_iters = sum(int(np.asarray(r.iters).sum()) for r in raws)
    lanes = chunk * chunks
    return {
        "lps_per_sec": round(lanes / raw_wall, 2),
        "wall_sec": round(raw_wall, 3),
        "optimal": raw_optimal,
        "recovered_lps_per_sec": round(lanes / wall, 2),
        "recovered_wall_sec": round(wall, 3),
        "recovered_optimal": ns,
        "lanes": lanes,
        "chunks": chunks,
        # RAW Newton-step median across ALL chunks (the first-chunk
        # post-recovery median mixed crossover pivots in and ignored
        # 3/4 of the lanes -- ADVICE r4)
        "median_iters": int(np.median(np.concatenate(
            [np.asarray(r.iters) for r in raws]
        ))),
        "eps_rel": 1e-3,
        "efficiency": _efficiency(
            total_iters, raw_wall, 2 * m * n * m + 2 * m**3
        ),
    }


def run_warm_ipm(jax, m, n, chunk, chunks=4, perturb=0.02):
    """IPM warm-start datapoint: scenario re-solves.

    Solves ``chunks`` batches cold (keeping terminal iterates), perturbs
    every rhs by ``perturb`` relative noise, then re-solves the scenario
    twice -- warm (``reoptimize_ipm_batch_canonical``: restart from the
    previous iterate with complementarity lifted to the mu0 shell, no
    starting-point factorization) and cold -- with identical configs and
    async dispatch chains.  The batched while_loop's wall follows the
    MAX iteration count per chunk, so the measured ratio is the honest
    one (CPU probes: warm max 8-9 vs cold 10-11 Newton steps + the
    skipped extra factorization at a 1-2% perturbation)."""
    from linprog_tpu import status as stt
    from linprog_tpu.generators import device_inequality_lps
    from linprog_tpu.ipm import (
        IPMConfig,
        ipm_solve_batch_canonical,
        reoptimize_ipm_batch_canonical,
    )

    keys = jax.random.split(jax.random.PRNGKey(5), chunks)
    gen = jax.jit(lambda k: device_inequality_lps(k, chunk, m, n))
    batches = [gen(k) for k in keys]
    cfg = IPMConfig(eps_rel=1e-3, maxiters=40, dtype="float32")

    @jax.jit
    def perturb_h(h, k):
        return h * (1.0 + perturb * jax.random.normal(k, h.shape, h.dtype))

    # base solves (cold) keeping the terminal states
    base = [ipm_solve_batch_canonical(*b, cfg, return_state=True)
            for b in batches]
    states = [s for _, s in base]
    new_hs = [perturb_h(b[2], jax.random.fold_in(k, 1))
              for b, k in zip(batches, keys)]

    def warm_all():
        return [
            reoptimize_ipm_batch_canonical(b[0], b[1], hn, s, cfg)
            for b, hn, s in zip(batches, new_hs, states)
        ]

    def cold_all():
        return [ipm_solve_batch_canonical(b[0], b[1], hn, cfg)
                for b, hn in zip(batches, new_hs)]

    for leg in (warm_all, cold_all):  # compile + warm both legs
        np.asarray(leg()[-1].cost)
    t0 = time.time()
    warm = warm_all()
    warm_opt = sum(int((np.asarray(r.status) == stt.OPTIMAL).sum())
                   for r in warm)
    warm_wall = time.time() - t0
    t0 = time.time()
    cold = cold_all()
    cold_opt = sum(int((np.asarray(r.status) == stt.OPTIMAL).sum())
                   for r in cold)
    cold_wall = time.time() - t0
    lanes = chunk * chunks
    return {
        "lps_per_sec": round(lanes / warm_wall, 2),
        "wall_sec": round(warm_wall, 3),
        "optimal": warm_opt,
        "cold_lps_per_sec": round(lanes / cold_wall, 2),
        "cold_optimal": cold_opt,
        "speedup_vs_cold": round(cold_wall / warm_wall, 2),
        "lanes": lanes,
        "perturb": perturb,
        "median_warm_iters": int(np.median(np.concatenate(
            [np.asarray(r.iters) for r in warm]))),
        "median_cold_iters": int(np.median(np.concatenate(
            [np.asarray(r.iters) for r in cold]))),
        "eps_rel": 1e-3,
    }


def run_ipm_crossover(jax, m, n, chunk, highs_samples=2):
    """Exact-pipeline leg: IPM -> crossover -> simplex fallback, certified.

    The leg runs ``router.solve_batch_exact`` END TO END -- the gathered two-phase
    fallback for any uncrossed lane is INSIDE the measured wall, so the
    reported vertex-exact count is every lane, reproducibly (f32
    reduction nondeterminism may move a lane between the crossover and
    the fallback path, but not out of exactness).  Every lane's returned
    basis is then verified against the full KKT system with double-word
    residuals (``certify.certify_vertex_batch``) -- oracle-free evidence
    of the same contract the HiGHS gap samples spot-check."""
    from linprog_tpu.certify import certificate_summary, certify_vertex_batch
    from linprog_tpu.generators import device_inequality_lps
    from linprog_tpu.router import solve_batch_exact

    c, G, h = device_inequality_lps(jax.random.PRNGKey(0), chunk, m, n)

    def run():
        return solve_batch_exact(c, G, h)

    res, info = run()  # compile + warm (incl. the fallback bucket if hit)
    np.asarray(res.cost)
    t0 = time.time()
    res, info = run()
    np.asarray(res.cost)
    wall = time.time() - t0
    t1 = time.time()
    cert = certificate_summary(certify_vertex_batch(c, G, h, res.basis))
    cert_wall = time.time() - t1

    gaps = []
    try:
        from scipy.optimize import linprog as scipy_linprog

        costs = np.asarray(res.cost)
        for i in range(min(highs_samples, chunk)):
            ref = scipy_linprog(
                np.asarray(c[i]), A_ub=np.asarray(G[i]),
                b_ub=np.asarray(h[i]), bounds=(0, None), method="highs",
            )
            if ref.status == 0:
                gaps.append(
                    abs(float(costs[i]) - ref.fun) / max(1, abs(ref.fun))
                )
    except Exception:
        pass
    return {
        "lps_per_sec": round(chunk / wall, 2),
        "wall_sec": round(wall, 3),
        "crossed": info["crossed"],
        "fallback": info["fallback"],
        "lanes": chunk,
        "certified": cert["certified"],
        "cert": cert,
        "cert_wall_sec": round(cert_wall, 3),
        "max_rel_gap_vs_highs": float(f"{max(gaps):.3e}") if gaps else None,
    }


def run_sparse_ipm(jax, m, n, chunk, density=0.01):
    """Shared-pattern sparse IPM datapoint + sparse-PDHG head-to-head.

    128 lanes of m=n=2048 at 1% density; the sparse PDHG runs on the
    SAME instances at eps 1e-4."""
    import jax.numpy as jnp

    from linprog_tpu import status as stt
    from linprog_tpu.generators import (
        device_sparse_inequality_lps,
        random_sparse_pattern,
    )
    from linprog_tpu.ipm import IPMConfig
    from linprog_tpu.ipm_sparse import (
        SparsePattern,
        ipm_solve_batch_sparse_canonical,
    )
    from linprog_tpu.pdhg import PDHGConfig, pdhg_solve_batch_sparse

    from linprog_tpu.ipm_sparse import recover_stragglers_sparse

    rows, cols = random_sparse_pattern(m, n, density, seed=0)
    pat = SparsePattern(rows, cols, m, n)
    c, vals, h = jax.jit(
        lambda k: device_sparse_inequality_lps(k, chunk, rows, cols, m, n)
    )(jax.random.PRNGKey(0))
    cfg = IPMConfig(eps_rel=1e-3, maxiters=40, frac=0.995)

    def ipm():
        return ipm_solve_batch_sparse_canonical(
            c, rows, cols, vals, h, (m, n), cfg, pattern=pat
        )

    res = ipm()
    np.asarray(res.cost)
    t0 = time.time()
    res = ipm()
    ns = int((np.asarray(res.status) == stt.OPTIMAL).sum())
    wall = time.time() - t0
    # recovered leg: densify ONLY the
    # straggler bucket and repair it through the pooled dense crossover;
    # warm covers the bucket's compile (same key -> same stragglers)
    recover_stragglers_sparse(c, rows, cols, vals, h, (m, n), res)
    t0 = time.time()
    res_r = ipm()
    res_r = recover_stragglers_sparse(c, rows, cols, vals, h, (m, n),
                                      res_r)
    ns_rec = int((np.asarray(res_r.status) == stt.OPTIMAL).sum())
    rec_wall = time.time() - t0

    # first-order comparator at ITS accuracy class on the same data
    lb = jnp.zeros((chunk, n), jnp.float32)
    ub = jnp.full((chunk, n), jnp.inf, jnp.float32)
    pcfg = PDHGConfig(eps_rel=1e-4, adaptive=True, stall_reset_beta=0.95)

    def pdhg():
        return pdhg_solve_batch_sparse(
            c, rows, cols, vals, h, 0, lb, ub, (m, n),
            maxiters=60_000, cfg=pcfg,
        )

    st8 = pdhg()
    np.asarray(st8.x[:, 0])
    t0 = time.time()
    st8 = pdhg()
    np_ = int((np.asarray(st8.status) == stt.OPTIMAL).sum())
    pwall = time.time() - t0
    return {
        "lps_per_sec": round(chunk / wall, 2),
        "wall_sec": round(wall, 3),
        "optimal": ns,
        "recovered_lps_per_sec": round(chunk / rec_wall, 2),
        "recovered_wall_sec": round(rec_wall, 3),
        "recovered_optimal": ns_rec,
        "lanes": chunk,
        "nnz": int(rows.shape[0]),
        "density": density,
        "median_iters": int(np.median(np.asarray(res.iters))),
        "eps_rel": 1e-3,
        "pdhg_same_instances": {
            "lps_per_sec": round(chunk / pwall, 2),
            "optimal": np_,
            "eps_rel": 1e-4,
        },
    }


def run_exact4096(jax, chunk=4):
    """m=4096 EXACT datapoint: the full exact pipeline, self-certified.

    The leg runs ``router.solve_batch_exact`` -- IPM -> crossover at
    ``exact_cleanup_config(4096)`` (seg=384, budget 2048) plus a
    double-budget retry for uncrossed lanes, ALL inside the measured
    wall.  No HiGHS
    oracle exists at this size (hours per instance), so every lane's
    returned basis is verified on device against the full KKT system
    with double-word residuals (``certify``): exact refactorized
    B^-1 h >= 0, reduced costs >= 0, primal residual and duality gap at
    the ~1e-7 class.  ``certified`` counts the lanes with that evidence;
    ``uncrossed`` lanes keep their IPM answer and honest status."""
    from linprog_tpu.certify import certificate_summary, certify_vertex_batch
    from linprog_tpu.generators import device_inequality_lps
    from linprog_tpu.router import solve_batch_exact

    m = n = 4096
    c, G, h = jax.jit(lambda k: device_inequality_lps(k, chunk, m, n))(
        jax.random.PRNGKey(0))

    def run():
        return solve_batch_exact(c, G, h)

    res, info = run()
    np.asarray(res.cost)
    t0 = time.time()
    res, info = run()
    np.asarray(res.cost)
    wall = time.time() - t0
    t1 = time.time()
    cert = certificate_summary(certify_vertex_batch(c, G, h, res.basis))
    cert_wall = time.time() - t1
    return {
        "lps_per_sec": round(chunk / wall, 3),
        "wall_sec": round(wall, 3),
        "crossed": info["crossed"],
        "fallback": info["fallback"],
        "retry_crossed": info.get("retry_crossed", 0),
        "uncrossed": info.get("uncrossed", 0),
        "lanes": chunk,
        "certified": cert["certified"],
        "cert": cert,
        "cert_wall_sec": round(cert_wall, 3),
    }


def run_router(jax, m, n, chunk):
    """Auto-router datapoint: records the family chosen for this regime
    (must match the measured per-family optimum) and its throughput."""
    from linprog_tpu import solve_batch_auto
    from linprog_tpu import status as stt
    from linprog_tpu.generators import device_inequality_lps

    c, G, h = device_inequality_lps(jax.random.PRNGKey(0), chunk, m, n)

    def run():
        return solve_batch_auto(c, G, h, accuracy=1e-3)

    res, info = run()  # compile + warm
    np.asarray(res.cost)
    t0 = time.time()
    res, info = run()
    ns = int((np.asarray(res.status) == stt.OPTIMAL).sum())
    wall = time.time() - t0
    return {
        "family": info["family"],
        "lps_per_sec": round(chunk / wall, 2),
        "wall_sec": round(wall, 3),
        "optimal": ns,
        "lanes": chunk,
        "accuracy": 1e-3,
    }


def _digest_leg(leg):
    """One extra-leg dict -> a compact evidence row.

    Keeps the 3-5 numbers each claim rests on: throughput,
    recovered throughput, optimal/crossed/certified counts vs lanes, and
    the accuracy evidence -- so every leg survives a truncated log tail
    even when the full JSON does not."""
    if not isinstance(leg, dict):
        return leg
    row = {}
    for src, dst in (
        ("lps_per_sec", "lps"),
        ("recovered_lps_per_sec", "rec_lps"),
        ("vs_baseline", "x"),
        ("optimal", "opt"),
        ("recovered_optimal", "rec_opt"),
        ("crossed", "crossed"),
        ("fallback", "fb"),
        ("retry_crossed", "retry"),
        ("uncrossed", "unc"),
        ("certified", "cert"),
        ("lanes", "lanes"),
        ("max_rel_gap_vs_highs", "gap"),
        ("speedup_vs_cold", "xwarm"),
        ("family", "fam"),
    ):
        v = leg.get(src)
        if v is None or v != v:  # drop None/NaN
            continue
        if dst in ("fb", "retry", "unc") and not v:
            continue  # zero-valued repair counters add no evidence
        row[dst] = v
    ls = leg.get("lane_status")
    if ls and "opt" not in row:
        row["opt"] = ls.get("optimal")
    cert = leg.get("cert")
    if cert:
        row["kkt"] = max(cert["max_primal_residual"], cert["max_gap"])
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=1024, help="lanes per device batch")
    ap.add_argument("--chunks", type=int, default=10, help="number of batches")
    ap.add_argument("--maxiters", type=int, default=2000)
    # median over 16: single-core HiGHS timing varies ~2x with machine
    # load and the headline multiplier inherits that noise
    ap.add_argument("--highs-samples", type=int, default=16)
    ap.add_argument("--quick", action="store_true", help="small fast run")
    ap.add_argument(
        "--sizes", default="512,1024,2048",
        help="comma-separated extra m(=n) datapoints ('' to skip)",
    )
    args = ap.parse_args()
    if args.quick:
        args.chunk, args.chunks, args.m, args.n = 256, 2, 64, 64
        args.sizes = ""

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX found "
                 f"{jax.devices()[0].platform!r}")
    from linprog_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = _device_info(jax)

    from linprog_tpu.config import tuned_config

    cfg = tuned_config(args.m)

    extras = {}
    if not args.quick and args.m == 256 and args.n == 256:
        # headline: the exact router pipeline (IPM -> crossover ->
        # simplex fallback); the simplex pipeline stays as an extra.
        head = run_exact_head(jax, args.m, args.n, args.chunk, args.chunks,
                              args.highs_samples)
        extras["simplex_m256"] = run_size(
            jax, 256, 256, args.chunk, 2, args.maxiters, cfg, 4
        )
    else:
        head = run_size(jax, args.m, args.n, args.chunk, args.chunks,
                        args.maxiters, cfg, args.highs_samples)
    # extra size datapoints: lanes per chunk shrink as m grows
    size_cfg = {
        512: dict(chunk=256, chunks=1, maxiters=4000, highs_samples=2),
        1024: dict(chunk=32, chunks=1, maxiters=6000, highs_samples=1),
        # one HiGHS sample: ~2 min single-core at this size
        2048: dict(chunk=8, chunks=1, maxiters=20000, highs_samples=1),
    }
    for tok in filter(None, args.sizes.split(",")):
        m = int(tok)
        sc = size_cfg.get(m, dict(chunk=32, chunks=1, maxiters=6000,
                                  highs_samples=1))
        extras[f"m{m}"] = run_size(
            jax, m, m, sc["chunk"], sc["chunks"], sc["maxiters"],
            tuned_config(m), sc["highs_samples"],
        )
    if args.sizes:
        # bounded solves take ~2000-2400 iterations at m=256 (bound
        # flips each count one): 3x the plain-engine budget, a segment
        # that covers most of a solve, and the bound-aware dd polish
        extras["bounded_m256"] = run_bounded(
            jax, 256, 256, 1024, 3 * args.maxiters,
            cfg.replace(pricing="dantzig", polish_pivots=8,
                        refactor_every=2048), 4,
        )
        extras["warm_rhs_m256"] = run_warm_start(
            jax, 256, 256, 1024, args.maxiters, cfg,
        )
        extras["pdhg_m256"] = run_pdhg_batch(jax, 256, 256, 1024)
        # interior-point family across sizes: few Newton steps regardless
        # of m, so it overtakes the pivot-bound simplex path as m grows
        extras["ipm_m256"] = run_ipm_batch(jax, 256, 256, 256)
        extras["ipm_m512"] = run_ipm_batch(jax, 512, 512, 128)
        # warm-started scenario re-solves for the IPM family
        extras["warm_ipm_m512"] = run_warm_ipm(jax, 512, 512, 128)
        extras["ipm_m1024"] = run_ipm_batch(jax, 1024, 1024, 64)
        extras["ipm_m2048"] = run_ipm_batch(jax, 2048, 2048, 16)
        # exact vertices from the IPM family (dual-then-primal crossover
        # cleanup) at the tuned-segment and the tight-cadence sizes
        extras["ipm_xover_m256"] = run_ipm_crossover(jax, 256, 256, 256)
        extras["ipm_xover_m1024"] = run_ipm_crossover(jax, 1024, 1024, 32, 1)
        # the sparse scaling frontier: shared-pattern sparse IPM
        # vs the sparse PDHG on the same instances
        extras["sparse_ipm_m2048"] = run_sparse_ipm(jax, 2048, 2048, 128)
        # m=4096 exact route
        extras["exact_m4096"] = run_exact4096(jax)
        # auto-router: family choice must match the measured optimum for
        # the regime (m=512 at eps 1e-3 -> ipm)
        extras["router_m512"] = run_router(jax, 512, 512, 128)

    out = {
        "metric": f"batched_lps_per_sec_m{args.m}_n{args.n}",
        "value": head["lps_per_sec"],
        "unit": "LPs/s/device",
        "vs_baseline": head["vs_baseline"],
        "pivots_per_sec_per_chip": head.get(
            "pivots_per_sec", head.get("iters_per_sec")
        ),
        "total_lps": head["total_lps"],
        "wall_sec": head["wall_sec"],
        "highs_single_core_lps_per_sec": head["highs_single_core_lps_per_sec"],
        "max_rel_gap_vs_highs": head["max_rel_gap_vs_highs"],
        "lane_status": head["lane_status"],
        "device": device,
    }
    for k in ("family", "crossed", "fallback", "certified",
              "max_kkt_residual", "cert_wall_sec", "cert_error",
              "efficiency"):
        if k in head:
            out[k] = head[k]
    for k, v in extras.items():
        out[k] = v
    print(json.dumps(out), flush=True)
    # a COMPACT digest line compressing every extra to its key numbers,
    # printed before the headline so both fit a truncated log tail
    print(json.dumps({"digest": {k: _digest_leg(v)
                                 for k, v in extras.items()}},
                     separators=(",", ":")), flush=True)
    # re-print a compact headline line LAST so the tail always parses to
    # the headline number
    headline = {
        "metric": out["metric"],
        "value": out["value"],
        "unit": out["unit"],
        "vs_baseline": out["vs_baseline"],
        "max_rel_gap_vs_highs": out["max_rel_gap_vs_highs"],
        "lane_status": out["lane_status"],
        "device": device,
    }
    for k in ("certified", "max_kkt_residual"):
        if out.get(k) is not None:
            headline[k] = out[k]
    print(json.dumps(headline), flush=True)


if __name__ == "__main__":
    main()
