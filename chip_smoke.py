#!/usr/bin/env python3
"""Smoke check of the batched LP solver on one NVIDIA GPU.

    python chip_smoke.py             # phases 0-5 on one GPU
    python chip_smoke.py --chips 4   # only the batch-sharded exact path on a
                                     # 4-GPU mesh, against device 0

Every phase drives public entry points at full size and compares what
comes out with a plain reference: NumPy float64 or single-core HiGHS
(``scipy.optimize.linprog``).  Each phase prints one line; a failed phase
prints its traceback, the later phases still run, and the script exits 1
without a result line.  On success the last line is one JSON object
naming the device as JAX reports it.  Without a GPU the script exits 2
before any phase runs.

The phase functions take their sizes as arguments so the test suite can
run them at tiny sizes on the CPU; only :func:`main` insists on a GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))

OPTIMAL = 1  # linprog_tpu.status.OPTIMAL, checked against the package below


def _rel_gap(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


def _highs(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, bounds=(0, None)):
    """``(status, objective)`` of single-core HiGHS on one LP."""
    from scipy.optimize import linprog

    r = linprog(np.asarray(c, np.float64), A_ub=A_ub, b_ub=b_ub,
                A_eq=A_eq, b_eq=b_eq, bounds=bounds, method="highs")
    return int(r.status), float(r.fun) if r.status == 0 else float("nan")


class _Inline(concurrent.futures.Executor):
    """Runs each job at submit time (the test suite's stand-in for the
    worker pool :func:`main` uses)."""

    def submit(self, fn, /, *args, **kwargs):
        f = concurrent.futures.Future()
        try:
            f.set_result(fn(*args, **kwargs))
        except Exception as e:  # noqa: BLE001 -- re-raised by .result()
            f.set_exception(e)
        return f


def _submit_canonical(pool, c, G, h, lanes):
    """HiGHS jobs for ``min c'x, Gx <= h, x >= 0`` on ``lanes``; submitted
    before the device solve so single-core HiGHS overlaps it."""
    c, G, h = (np.asarray(a, np.float64) for a in (c, G, h))
    return {i: pool.submit(_highs, c[i], A_ub=G[i], b_ub=h[i]) for i in lanes}


def _highs_results(futures):
    """``{lane: objective}``; every reference must be optimal."""
    out = {}
    for i, f in futures.items():
        status, fun = f.result()
        _check(status == 0, f"HiGHS status {status} on lane {i}")
        out[i] = fun
    return out


def _max_gap(cost, refs):
    cost = np.asarray(cost)
    return float(max(_rel_gap(cost[i], v) for i, v in refs.items()))


def _timed(fn):
    """``(result, first_s, steady_s)``: the first call compiles, the second
    is timed on its own; both end in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, first, time.perf_counter() - t0


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase_device(require_gpu_tools: bool = True) -> dict:
    """Phase 0: what JAX sees, the card's name and power limit, the cache."""
    import jax

    from linprog_tpu.compile_cache import enable_compile_cache

    d = jax.devices()[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "jax": jax.__version__,
            "compile_cache": enable_compile_cache()}
    try:
        info["nvidia_smi"] = nvidia_smi_line()
    except (OSError, subprocess.SubprocessError):
        if require_gpu_tools:
            raise
        info["nvidia_smi"] = "not available"
    return info


def phase_precision(B: int = 64, m: int = 256, seed: int = 0) -> dict:
    """Phase 1: f32 batched matmuls run at full f32, not TF32.

    The package sets ``jax_default_matmul_precision="highest"`` on import.
    TF32 keeps 10 mantissa bits (max relative error ~1e-3 here), enough to
    flip pivot choices; full f32 stays near 1e-7.
    """
    import jax
    import jax.numpy as jnp

    import linprog_tpu  # noqa: F401  (sets the matmul precision)

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, m, m)).astype(np.float32)
    Y = rng.standard_normal((B, m, m)).astype(np.float32)
    Z = jax.jit(lambda a, b: jnp.einsum("bij,bjk->bik", a, b))(
        jnp.asarray(X), jnp.asarray(Y))
    ref = np.einsum("bij,bjk->bik", X.astype(np.float64),
                    Y.astype(np.float64))
    err = float(np.max(np.abs(np.asarray(Z, np.float64) - ref))
                / np.max(np.abs(ref)))
    _check(err <= 1e-5, f"batched f32 einsum max rel error {err:.3e} > 1e-5")
    return {"max_rel_err": err}


def phase_main_path(B: int = 1024, m: int = 256, seed: int = 0,
                    highs_lanes: int = 16, gap_tol: float = 1e-5,
                    pool=None) -> dict:
    """Phase 2: the exact pipeline (IPM -> crossover -> fallback) and the
    auto-router at accuracy 1e-6, every lane OPTIMAL, certified, and on 16
    lanes within ``gap_tol`` of HiGHS."""
    import jax
    import jax.numpy as jnp

    from linprog_tpu import router
    from linprog_tpu.certify import certify_vertex_batch
    from linprog_tpu.generators import device_inequality_lps

    gen = jax.jit(device_inequality_lps, static_argnums=(1, 2, 3))
    c, G, h = gen(jax.random.PRNGKey(seed), B, m, m)
    refs = _submit_canonical(pool or _Inline(), c, G, h,
                             range(min(highs_lanes, B)))
    # the certificate compiles on a slack basis of the same shape while
    # the pipeline compiles
    slack = jnp.broadcast_to(jnp.arange(m, 2 * m, dtype=jnp.int32), (B, m))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        warm = ex.submit(lambda: jax.block_until_ready(
            certify_vertex_batch(c, G, h, slack)))
        (res, info), first, steady = _timed(
            lambda: router.solve_batch_exact(c, G, h))
        warm.result()
    status = np.asarray(res.status)
    n_opt = int((status == OPTIMAL).sum())
    _check(n_opt == B, f"exact pipeline: {n_opt}/{B} lanes OPTIMAL ({info})")

    cert = certify_vertex_batch(c, G, h, res.basis)
    n_cert = int(np.asarray(cert["certified"]).sum())
    _check(n_cert >= B - 1, f"certified {n_cert}/{B} < {B - 1}")

    gap = _max_gap(res.cost, _highs_results(refs))
    _check(gap <= gap_tol, f"exact vs HiGHS gap {gap:.3e} > {gap_tol}")

    auto, auto_info = router.solve_batch_auto(c, G, h, accuracy=1e-6)
    a_status = np.asarray(auto.status)
    a_opt = int((a_status == OPTIMAL).sum())
    _check(a_opt == B, f"solve_batch_auto: {a_opt}/{B} lanes OPTIMAL")
    a_gap = float(_rel_gap(auto.cost, res.cost).max())
    _check(a_gap <= gap_tol,
           f"solve_batch_auto vs exact cost gap {a_gap:.3e} > {gap_tol}")
    return {
        "lanes": B, "m": m, "optimal": n_opt, "certified": n_cert,
        "crossed": info["crossed"], "fallback": info["fallback"],
        "highs_gap": gap, "first_call_s": first, "steady_s": steady,
        "lps_per_s": B / steady, "auto_family": auto_info["family"],
        "auto_vs_exact_gap": a_gap,
        "_data": (c, G, h, res),
    }


def _site_two_phase(B, m, seed, highs_lanes, gap_tol, pool, refs=None):
    import jax

    from linprog_tpu.batch import solve_batch_two_phase
    from linprog_tpu.config import tuned_config
    from linprog_tpu.generators import (
        device_inequality_lps,
        device_standard_form_batch,
    )

    c, G, h = device_inequality_lps(jax.random.PRNGKey(seed), B, m, m)
    if refs is None:
        refs = _submit_canonical(pool, c, G, h, range(min(highs_lanes, B)))
    cs, As, bs = device_standard_form_batch(c, G, h)
    it = max(2000, 4 * m)
    cfg = tuned_config(m)
    res, first, steady = _timed(
        lambda: solve_batch_two_phase(cs, As, bs, it, it, cfg))
    n_opt = int((np.asarray(res.status) == OPTIMAL).sum())
    _check(n_opt == B, f"two-phase m={m}: {n_opt}/{B} OPTIMAL")
    gap = _max_gap(res.cost, _highs_results(refs))
    _check(gap <= gap_tol, f"two-phase m={m} HiGHS gap {gap:.3e}")
    return {"optimal": n_opt, "highs_gap": gap, "first_call_s": first,
            "steady_s": steady}


def _site_bounded(B, m, seed, highs_lanes, gap_tol, pool):
    import jax
    import jax.numpy as jnp

    from linprog_tpu import bounded as bnd
    from linprog_tpu.batch import solve_batch_bounded
    from linprog_tpu.config import tuned_config
    from linprog_tpu.generators import device_bounded_lps

    n = m
    c, A, b, lb, ub = device_bounded_lps(jax.random.PRNGKey(seed), B, m, n)
    basis = jnp.broadcast_to(jnp.arange(n, n + m, dtype=jnp.int32), (B, m))
    vs = jnp.concatenate([jnp.zeros((B, n), jnp.int8),
                          jnp.full((B, m), int(bnd.BASIC), jnp.int8)], axis=1)
    cn, An, bn = (np.asarray(a, np.float64) for a in (c, A, b))
    lbn, ubn = np.asarray(lb, np.float64), np.asarray(ub, np.float64)
    refs = {i: pool.submit(
        _highs, cn[i], A_eq=An[i], b_eq=bn[i],
        bounds=[(lo, None if np.isinf(hi) else hi)
                for lo, hi in zip(lbn[i], ubn[i])])
        for i in range(min(highs_lanes, B))}
    cfg = tuned_config(m)
    res, first, steady = _timed(lambda: solve_batch_bounded(
        c, A, b, lb, ub, basis, vs, 12 * m, cfg))
    n_opt = int((np.asarray(res.status) == OPTIMAL).sum())
    _check(n_opt == B, f"bounded m={m}: {n_opt}/{B} OPTIMAL")
    gap = _max_gap(res.cost, _highs_results(refs))
    _check(gap <= gap_tol, f"bounded m={m} HiGHS gap {gap:.3e}")
    return {"optimal": n_opt, "highs_gap": gap, "first_call_s": first,
            "steady_s": steady}


def _site_warm_rhs(B, m, seed, highs_lanes, gap_tol, pool, perturb=0.02):
    import jax
    import jax.numpy as jnp

    from linprog_tpu.batch import reoptimize_batch_new_rhs, solve_batch_two_phase
    from linprog_tpu.config import tuned_config
    from linprog_tpu.generators import (
        device_inequality_lps,
        device_standard_form_batch,
    )

    c, G, h = device_inequality_lps(jax.random.PRNGKey(seed), B, m, m)
    cs, As, bs = device_standard_form_batch(c, G, h)
    it = max(2000, 4 * m)
    cfg = tuned_config(m)
    base = solve_batch_two_phase(cs, As, bs, it, it, cfg)
    _check(bool(np.all(np.asarray(base.status) == OPTIMAL)),
           "warm-RHS base solve not all OPTIMAL")
    _check(bool(np.all(np.asarray(base.basis) < cs.shape[1])),
           "warm-RHS base basis holds artificial columns")
    rng = np.random.default_rng(seed + 1)
    bs_new = jnp.asarray(np.asarray(bs) * (
        1.0 + perturb * rng.standard_normal(bs.shape)).astype(np.float32))
    csn, Asn, bsn = (np.asarray(a, np.float64) for a in (cs, As, bs_new))
    refs = {i: pool.submit(_highs, csn[i], A_eq=Asn[i], b_eq=bsn[i])
            for i in range(min(highs_lanes, B))}
    res, first, steady = _timed(lambda: reoptimize_batch_new_rhs(
        cs, As, bs_new, base.basis, it, cfg))
    status = np.asarray(res.status)
    gaps = []
    for i, f in refs.items():
        ref_status, ref_fun = f.result()
        _check((ref_status == 0) == (status[i] == OPTIMAL),
               f"warm-RHS lane {i}: status {status[i]} vs HiGHS {ref_status}")
        if ref_status == 0:
            gaps.append(_rel_gap(np.asarray(res.cost)[i], ref_fun))
    gap = float(np.max(gaps))
    _check(gap <= gap_tol, f"warm-RHS m={m} HiGHS gap {gap:.3e}")
    return {"optimal": int((status == OPTIMAL).sum()), "highs_gap": gap,
            "mean_iters": float(np.asarray(res.iters).mean()),
            "first_call_s": first, "steady_s": steady}


def _site_ipm(B, m, seed, highs_lanes, eps, pool, refs=None):
    """Batched IPM at ``eps``.

    The f32 normal equations stop each lane at a KKT floor that depends
    on its conditioning, near 1e-3 at m=1024, so not every lane reaches
    ``eps``.  The check asks that the median lane does (at least B/2
    OPTIMAL): a median floor above ``eps`` would mean the f32 IPM itself
    is broken.  The OPTIMAL lanes among those given HiGHS references
    (``refs``, submitted before the solve so HiGHS overlaps it) are within
    10x eps of HiGHS.
    """
    import jax

    from linprog_tpu.generators import device_inequality_lps
    from linprog_tpu.ipm import IPMConfig, ipm_solve_batch_canonical

    c, G, h = device_inequality_lps(jax.random.PRNGKey(seed), B, m, m)
    if refs is None:
        refs = _submit_canonical(pool, c, G, h, range(min(highs_lanes, B)))
    cfg = IPMConfig(eps_rel=eps)
    res, first, steady = _timed(
        lambda: ipm_solve_batch_canonical(c, G, h, cfg))
    raw_ok = np.asarray(res.status) == OPTIMAL
    ok = np.flatnonzero(raw_ok)
    _check(ok.size >= B / 2, f"IPM m={m}: {ok.size}/{B} OPTIMAL")
    checked = {i: f for i, f in refs.items() if raw_ok[i]}
    if not checked:  # none of the early references is OPTIMAL here
        checked = _submit_canonical(pool, c, G, h, ok[:highs_lanes])
    gap = _max_gap(res.cost, _highs_results(checked))
    _check(gap <= 10 * eps, f"IPM m={m} HiGHS gap {gap:.3e} > {10 * eps}")
    return {"optimal": int(ok.size), "highs_gap": gap,
            "highs_lanes": sorted(int(i) for i in checked),
            "first_call_s": first, "steady_s": steady}


def _site_exact_repair(B, m, seed, highs_lanes, gap_tol, pool, refs=None):
    """The exact pipeline's repair path for lanes that fail to cross.

    A 1-pivot crossover budget with the weaker magnitude guess leaves
    lanes uncrossed.  Beyond the calibrated ``cleanup_tuned_seg_max_m``
    (below m=1536) they retry with the alternate guess, then fall back to
    the two-phase simplex; every lane must come back OPTIMAL within
    ``gap_tol`` of HiGHS.  At phase 2's shape the IPM and the crossover
    (every guess and budget) reuse phase 2's compiled programs.
    """
    import jax

    from linprog_tpu import router
    from linprog_tpu.certify import certify_vertex_batch
    from linprog_tpu.generators import device_inequality_lps

    c, G, h = device_inequality_lps(jax.random.PRNGKey(seed), B, m, m)
    if refs is None:
        refs = _submit_canonical(pool, c, G, h, range(min(highs_lanes, B)))
    (res, info), first, steady = _timed(lambda: router.solve_batch_exact(
        c, G, h, maxiters=1, guess="magnitude"))
    n_opt = int((np.asarray(res.status) == OPTIMAL).sum())
    _check(n_opt == B, f"exact repair m={m}: {n_opt}/{B} OPTIMAL ({info})")
    _check(info["retry_crossed"] + info["fallback"] > 0,
           f"exact repair m={m}: no lane took the repair path ({info})")
    n_cert = int(np.asarray(
        certify_vertex_batch(c, G, h, res.basis)["certified"]).sum())
    gap = _max_gap(res.cost, _highs_results(refs))
    _check(gap <= gap_tol, f"exact repair m={m} HiGHS gap {gap:.3e}")
    return {"optimal": n_opt, "certified": n_cert,
            "crossed": info["crossed"], "retry_crossed": info["retry_crossed"],
            "fallback": info["fallback"], "highs_gap": gap,
            "first_call_s": first, "steady_s": steady}


# site -> (lanes B, size m, lanes checked against HiGHS).  Sizes shared
# with another site or phase reuse its compiled programs: the warm-RHS
# base solve is the B=256 two-phase solve, and the exact repair runs at
# phase 2's shape.  Single-core HiGHS takes about a minute on one dense
# m=1024 LP, so those sites check fewer lanes.
SITES = {"two_phase_m256": (256, 256, 4), "two_phase_m1024": (8, 1024, 1),
         "bounded_m256": (64, 256, 4), "warm_rhs_m256": (256, 256, 4),
         "exact_repair_m256": (1024, 256, 4), "ipm_m1024": (64, 1024, 3)}

# sites in canonical form, whose HiGHS references phase_sites submits
# before any site runs
_CANONICAL = ("two_phase", "exact_repair", "ipm")


def phase_sites(sizes=None, seed: int = 1, gap_tol: float = 1e-5,
                pool=None) -> dict:
    """Phase 3: the two-phase simplex, bounded, warm-RHS, exact-repair
    and IPM sites.

    ``sizes`` maps site name to ``(B, m, highs_lanes)`` (default: the
    full-size checks in :data:`SITES`).  The canonical-form sites' HiGHS
    references are all submitted first, so the slow m=1024 ones run while
    the device works.  Each site is timed twice: the first call compiles.
    Each site prints its line as it finishes.
    """
    import jax

    from linprog_tpu.generators import device_inequality_lps

    sizes = SITES if sizes is None else sizes
    pool = pool or _Inline()
    refs = {name: _submit_canonical(
                pool, *device_inequality_lps(jax.random.PRNGKey(seed), B, m, m),
                range(min(lanes, B)))
            for name, (B, m, lanes) in sizes.items()
            if name.startswith(_CANONICAL)}

    def site(name, B, m, lanes):
        if name.startswith("two_phase"):
            r = _site_two_phase(B, m, seed, lanes, gap_tol, pool, refs[name])
        elif name.startswith("bounded"):
            r = _site_bounded(B, m, seed, lanes, gap_tol, pool)
        elif name.startswith("warm_rhs"):
            r = _site_warm_rhs(B, m, seed, lanes, gap_tol, pool)
        elif name.startswith("exact_repair"):
            r = _site_exact_repair(B, m, seed, lanes, gap_tol, pool,
                                   refs[name])
        elif name.startswith("ipm"):
            r = _site_ipm(B, m, seed, lanes, 1e-3, pool, refs[name])
        else:
            raise ValueError(f"unknown site {name!r}")
        print(f"  site {name} (B={B}, m={m}) {json.dumps(r)}", flush=True)
        return r

    return _run_concurrently(
        {name: (lambda a=(name, *shape): site(*a))
         for name, shape in sizes.items()})


def _run_concurrently(jobs: dict) -> dict:
    """Run ``{name: fn}`` in one thread each and return ``{name: result}``.

    XLA compiles outside the GIL, so independent solvers compile side by
    side instead of one after another; their runs share the one device.
    Every job runs to its end; failures are printed and then raised
    together.
    """
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futures = {name: ex.submit(fn) for name, fn in jobs.items()}
        concurrent.futures.wait(futures.values())
    failed = []
    for name, f in futures.items():
        if f.exception() is not None:
            traceback.print_exception(f.exception())
            failed.append(name)
    _check(not failed, f"failed: {failed}")
    return {name: f.result() for name, f in futures.items()}


def _pdhg_kkt_f64(c, G, h, x, y):
    """Relative primal residual, dual residual and duality gap of the
    PDHG answer to ``min c'x, Gx <= h, x >= 0`` in float64.  The duals
    follow the solver's Lagrangian ``c'x + y'(Gx - h)``, ``y >= 0``."""
    c, G, h, x, y = (np.asarray(a, np.float64) for a in (c, G, h, x, y))
    primal = np.linalg.norm(np.maximum(G @ x - h, 0.0)) / (
        1.0 + np.linalg.norm(h))
    dual = np.linalg.norm(np.minimum(c + G.T @ y, 0.0)) / (
        1.0 + np.linalg.norm(c))
    pobj, dobj = c @ x, -h @ y
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return {"primal_residual": float(primal), "dual_residual": float(dual),
            "duality_gap": float(gap), "min_y": float(y.min())}


def _sparse_lps(sparse_m, sparse_lanes, density, seed):
    from linprog_tpu.generators import random_sparse_inequality_lps

    return random_sparse_inequality_lps(
        sparse_lanes, sparse_m, sparse_m, density=density, seed=seed)


def submit_sparse_references(pool, sparse_m: int = 2048,
                             sparse_lanes: int = 16, density: float = 0.01,
                             seed: int = 2, highs_lanes: int = 4) -> dict:
    """HiGHS jobs for phase 4's sparse lanes (about a minute each at
    m=2048), built on the host so :func:`main` can submit them first."""
    import scipy.sparse as sp

    cs, rows, cols, vals, hs = _sparse_lps(sparse_m, sparse_lanes, density,
                                           seed)
    return {i: pool.submit(
        _highs, cs[i], b_ub=hs[i].astype(np.float64),
        A_ub=sp.csr_matrix((vals[i].astype(np.float64), (rows, cols)),
                           shape=(sparse_m, sparse_m)))
        for i in range(min(highs_lanes, sparse_lanes))}


def phase_families(pdhg_n: int = 2048, sparse_m: int = 2048,
                   sparse_lanes: int = 16, density: float = 0.01,
                   seed: int = 2, highs_lanes: int = 4, pool=None,
                   sparse_refs=None) -> dict:
    """Phase 4: PDHG on one dense LP (eps 1e-4) and the sparse router
    (accuracy 1e-3), each within 10x its eps.

    The PDHG answer is checked by its own KKT conditions recomputed in
    float64 (single-core HiGHS takes minutes on one dense n=2048 LP); the
    sparse lanes are checked against HiGHS (``sparse_refs`` from
    :func:`submit_sparse_references` with the same sizes, or submitted
    here)."""
    import jax

    from linprog_tpu.generators import device_inequality_lps
    from linprog_tpu.pdhg import PDHGConfig, PDHGSolver
    from linprog_tpu.router import solve_batch_auto_sparse

    refs = sparse_refs
    if refs is None:
        refs = submit_sparse_references(pool or _Inline(), sparse_m,
                                        sparse_lanes, density, seed,
                                        highs_lanes)
    cs, rows, cols, vals, hs = _sparse_lps(sparse_m, sparse_lanes, density,
                                           seed)

    c, G, h = (np.asarray(a)[0] for a in device_inequality_lps(
        jax.random.PRNGKey(seed), 1, pdhg_n, pdhg_n))
    t0 = time.perf_counter()
    r = PDHGSolver(c, G=G, h=h, config=PDHGConfig(eps_rel=1e-4)).solve()
    t_pdhg = time.perf_counter() - t0
    _check(r.optimum, f"PDHG n={pdhg_n}: status {r.status}")
    kkt = _pdhg_kkt_f64(c, G, h, r.x, r.y)
    _check(max(kkt["primal_residual"], kkt["dual_residual"],
               kkt["duality_gap"]) <= 1e-3 and kkt["min_y"] >= 0.0,
           f"PDHG n={pdhg_n} float64 KKT check {kkt}")
    print(f"  pdhg n={pdhg_n} iters={r.iters} {t_pdhg:.1f} s "
          f"{json.dumps(kkt)}", flush=True)

    t0 = time.perf_counter()
    res, info = solve_batch_auto_sparse(cs, rows, cols, vals, hs,
                                        (sparse_m, sparse_m), accuracy=1e-3)
    cost = np.asarray(res.cost)
    t_sparse = time.perf_counter() - t0
    sparse_gap = _max_gap(cost, _highs_results(refs))
    _check(sparse_gap <= 1e-2, f"sparse router HiGHS gap {sparse_gap:.3e}")
    return {"pdhg_kkt": kkt, "pdhg_iters": r.iters,
            "pdhg_first_call_s": t_pdhg, "sparse_family": info["family"],
            "sparse_gap": sparse_gap,
            "sparse_optimal": int((np.asarray(res.status) == OPTIMAL).sum()),
            "sparse_first_call_s": t_sparse}


def _certificate_f64(c, G, h, basis):
    """The certificate's four residuals recomputed in NumPy float64."""
    c, G, h = (np.asarray(a, np.float64) for a in (c, G, h))
    B, m, n = G.shape
    A = np.concatenate([G, np.broadcast_to(np.eye(m), (B, m, m))], axis=2)
    out = {k: np.zeros(B) for k in
           ("primal_residual", "min_xB", "min_reduced_cost", "gap")}
    for i in range(B):
        Bm = A[i][:, basis[i]]
        xB = np.linalg.solve(Bm, h[i])
        cB = np.where(basis[i] < n, c[i][np.minimum(basis[i], n - 1)], 0.0)
        y = np.linalg.solve(Bm.T, cB)
        h_scale = 1.0 + np.abs(h[i]).max()
        c_scale = 1.0 + np.abs(c[i]).max()
        out["primal_residual"][i] = np.abs(Bm @ xB - h[i]).max() / h_scale
        out["min_xB"][i] = xB.min() / h_scale
        out["min_reduced_cost"][i] = min((c[i] - y @ G[i]).min(),
                                         (-y).min()) / c_scale
        pobj = cB @ xB
        out["gap"][i] = abs(pobj - h[i] @ y) / (1.0 + abs(pobj))
    return out


def phase_double_word(c, G, h, basis, lanes: int = 16,
                      tol: float = 1e-6, gap_tol: float = 1e-5) -> dict:
    """Phase 5: the f32 double-word certificate agrees with float64, and a
    basis with one column swapped fails it.

    Dekker splits and TwoSum assume no multiply-add is fused into an FMA;
    if the compiler contracted them the dd residuals would drift from the
    float64 ones computed here from the same basis.  Only the primal and
    dual residual comparisons (and the scaled min x_B), held to ``tol``,
    test for that contraction.  The duality gap, which the certificate
    evaluates to about its own 1e-5 tolerance, is held to ``gap_tol`` as a
    sanity bound only: at that width it cannot catch the contraction.
    """
    import jax.numpy as jnp

    from linprog_tpu.certify import certify_vertex_batch

    lanes = min(lanes, len(basis))
    full = (c, G, h)
    # the certificate runs on the whole batch, at phase 2's compiled shape,
    # and the first ``lanes`` are compared
    basis = np.asarray(basis)
    cert = {k: np.asarray(v)[:lanes] for k, v in
            certify_vertex_batch(c, G, h, jnp.asarray(basis)).items()}
    c, G, h = (np.asarray(a)[:lanes] for a in (c, G, h))
    ref = _certificate_f64(c, G, h, basis[:lanes])
    diffs = {k: float(np.max(np.abs(cert[k].astype(np.float64) - ref[k])))
             for k in ref}
    _check(max(v for k, v in diffs.items() if k != "gap") <= tol
           and diffs["gap"] <= gap_tol, f"dd certificate vs float64: {diffs}")

    # swap out each lane's largest basic variable for the first nonbasic
    # column: a different vertex, which cannot be certified optimal
    m, n = G.shape[1], G.shape[2]
    xB = np.stack([np.linalg.solve(
        np.concatenate([G[i].astype(np.float64), np.eye(m)], 1)[:, b],
        h[i].astype(np.float64)) for i, b in enumerate(basis[:lanes])])
    bad = basis.copy()
    for i in range(lanes):
        bad[i, int(np.argmax(xB[i]))] = next(
            j for j in range(n + m) if j not in set(basis[i].tolist()))
    swapped = np.asarray(certify_vertex_batch(
        *full, jnp.asarray(bad))["certified"])[:lanes]
    _check(not swapped.any(),
           f"{int(swapped.sum())} lanes with a swapped column certified")
    return {"lanes": lanes, "max_abs_diff": diffs,
            "swapped_certified": int(swapped.sum())}


def phase_sharded(n_dev: int = 4, B: int = 1024, m: int = 256,
                  seed: int = 3, tol: float = 1e-5) -> dict:
    """Four-card path: the exact pipeline and the two-phase simplex with the
    batch sharded over an ``n_dev``-device ``"batch"`` mesh, against the
    same lanes solved on device 0.  Statuses must be identical and costs
    within ``tol`` relative; bit-identity is not expected (a per-device
    batch of B/n_dev may get another GEMM algorithm than B on one)."""
    import jax

    from linprog_tpu.batch import solve_batch_two_phase
    from linprog_tpu.config import tuned_config
    from linprog_tpu.generators import (
        device_inequality_lps,
        device_standard_form_batch,
    )
    from linprog_tpu.parallel import (
        make_batch_mesh,
        shard_batch,
        sharded_two_phase_solve,
    )
    from linprog_tpu.router import solve_batch_exact

    _check(len(jax.devices()) >= n_dev,
           f"need {n_dev} devices, have {len(jax.devices())}")
    mesh = make_batch_mesh(n_dev)
    with jax.default_device(jax.devices()[0]):
        c, G, h = device_inequality_lps(jax.random.PRNGKey(seed), B, m, m)
        cs, As, bs = device_standard_form_batch(c, G, h)
    it = max(2000, 4 * m)
    cfg = tuned_config(m)
    out = {}

    t0 = time.perf_counter()
    ref, _ = solve_batch_exact(c, G, h)
    ref_cost = np.asarray(ref.cost)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh, info = solve_batch_exact(*shard_batch(mesh, c, G, h))
    sh_cost = np.asarray(sh.cost)
    t_sh = time.perf_counter() - t0
    out["exact"] = _compare_lanes("exact", ref.status, ref_cost, sh.status,
                                  sh_cost, tol)
    out["exact"].update(device0_s=t_ref, sharded_s=t_sh,
                        crossed=info["crossed"], fallback=info["fallback"])

    t0 = time.perf_counter()
    ref = solve_batch_two_phase(cs, As, bs, it, it, cfg)
    ref_cost = np.asarray(ref.cost)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh = sharded_two_phase_solve(mesh, cs, As, bs, it, it, cfg)
    sh_cost = np.asarray(sh.cost)
    t_sh = time.perf_counter() - t0
    out["two_phase"] = _compare_lanes("two-phase", ref.status, ref_cost,
                                      sh.status, sh_cost, tol)
    out["two_phase"].update(device0_s=t_ref, sharded_s=t_sh,
                            cost_devices=len(sh.cost.sharding.device_set))
    _check(out["two_phase"]["cost_devices"] == n_dev,
           "two-phase result is not sharded over the mesh")
    return out


def _compare_lanes(name, ref_status, ref_cost, sh_status, sh_cost, tol):
    ref_status, sh_status = np.asarray(ref_status), np.asarray(sh_status)
    diff = int((ref_status != sh_status).sum())
    _check(diff == 0, f"{name}: {diff} lanes change status when sharded")
    gap = float(_rel_gap(sh_cost, ref_cost).max())
    _check(gap <= tol, f"{name}: sharded vs device-0 cost gap {gap:.3e}")
    return {"lanes": int(ref_status.size),
            "optimal": int((ref_status == OPTIMAL).sum()),
            "max_rel_cost_diff": gap}


def _run(name, fn, failures):
    t0 = time.perf_counter()
    try:
        out = fn()
    except Exception:  # noqa: BLE001 -- reported, and the run exits 1
        traceback.print_exc()
        print(f"[{name}] FAIL ({time.perf_counter() - t0:.1f} s)", flush=True)
        failures.append(name)
        return None
    shown = {k: v for k, v in out.items() if not k.startswith("_")}
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s) "
          f"{json.dumps(shown, default=str)}", flush=True)
    return out


def _import_repo_package():
    """Import ``linprog_tpu`` from this checkout, never from elsewhere."""
    sys.path.insert(0, _HERE)
    import linprog_tpu

    pkg_dir = os.path.dirname(os.path.abspath(linprog_tpu.__file__))
    if os.path.dirname(pkg_dir) != _HERE:
        raise ImportError(f"linprog_tpu imported from {pkg_dir}, "
                          f"not from this checkout ({_HERE})")
    from linprog_tpu import status

    assert status.OPTIMAL == OPTIMAL
    return linprog_tpu


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the batch-sharded path on four GPUs")
    args = ap.parse_args(argv)

    _import_repo_package()
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform!r}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    failures = []
    dev = _run("phase 0 device", phase_device, failures)
    if dev is not None:
        print(f"nvidia-smi: {dev['nvidia_smi']}", flush=True)
    if args.chips == 4:
        _run("four-card sharded", phase_sharded, failures)
    else:
        # HiGHS references run in worker processes (which never import
        # JAX) while the device solves
        pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=4, mp_context=multiprocessing.get_context("spawn"))
        try:
            # the slowest references first: they run during phases 1-3
            sparse_refs = submit_sparse_references(pool)
            _run("phase 1 precision", phase_precision, failures)
            main_out = _run("phase 2 main path",
                            lambda: phase_main_path(pool=pool), failures)
            # phases 3 and 4 compile side by side (see _run_concurrently);
            # their first calls and steady times share the host and device
            _run_concurrently({
                "3": lambda: _run("phase 3 sites",
                                  lambda: phase_sites(pool=pool), failures),
                "4": lambda: _run("phase 4 families", lambda: phase_families(
                    pool=pool, sparse_refs=sparse_refs), failures)})
            if main_out is not None:
                c, G, h, res = main_out["_data"]
                _run("phase 5 double-word",
                     lambda: phase_double_word(c, G, h, res.basis), failures)
            else:
                failures.append("phase 5 double-word (no phase 2 result)")
        finally:
            pool.shutdown(cancel_futures=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after start-up",
          flush=True)
    if failures:
        print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
