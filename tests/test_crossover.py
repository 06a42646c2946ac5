"""PDHG -> simplex crossover (linprog_tpu.crossover).

The crossover must (a) snap near-optimal first-order points to exact
vertices in a handful of pivots, (b) verify optimality with a basis
(HiGHS-tight objectives), and (c) degrade gracefully -- a useless guess
keeps the first-order answer and reports ``crossed == False`` rather
than corrupting the result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linprog as scipy_linprog

from linprog_tpu.config import SolverConfig
from linprog_tpu.crossover import (
    crossover_batch_canonical,
    pdhg_crossover_batch_canonical,
)
from linprog_tpu.generators import random_inequality_lps

CFG = SolverConfig(polish_pivots=0)


def _highs(c, G, h):
    return np.array([
        scipy_linprog(
            np.asarray(c[i]), A_ub=np.asarray(G[i]), b_ub=np.asarray(h[i]),
            bounds=(0, None), method="highs",
        ).fun
        for i in range(c.shape[0])
    ])


def test_crossover_from_near_optimal_point():
    """A perturbed optimal x crosses over in few pivots to the exact cost."""
    B, m, n = 6, 16, 24
    c, G, h = random_inequality_lps(B, m, n, seed=11)
    xstar = np.stack([
        scipy_linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                      method="highs").x
        for i in range(B)
    ])
    x0 = jnp.asarray(xstar) * (1.0 + 1e-4) + 1e-5  # smear off the vertex
    res, crossed = crossover_batch_canonical(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), x0, maxiters=64,
        cfg=CFG,
    )
    ref = _highs(c, G, h)
    assert np.asarray(crossed).all()
    gaps = np.abs(np.asarray(res.cost) - ref) / np.maximum(1, np.abs(ref))
    assert gaps.max() < 1e-5
    # near-optimal guess => near-zero cleanup work
    assert int(np.asarray(res.iters).max()) <= 8


def test_pdhg_crossover_beats_raw_pdhg_accuracy():
    B, m, n = 8, 24, 32
    c, G, h = random_inequality_lps(B, m, n, seed=3)
    c, G, h = jnp.asarray(c), jnp.asarray(G), jnp.asarray(h)
    from linprog_tpu.pdhg import pdhg_solve_batch_canonical

    x_raw, cost_raw, *_ = pdhg_solve_batch_canonical(c, G, h, maxiters=4000)
    res, crossed = pdhg_crossover_batch_canonical(
        c, G, h, pdhg_maxiters=4000, cfg=CFG
    )
    ref = _highs(c, G, h)
    gaps_raw = np.abs(np.asarray(cost_raw) - ref) / np.maximum(1, np.abs(ref))
    gaps = np.abs(np.asarray(res.cost) - ref) / np.maximum(1, np.abs(ref))
    ok = np.asarray(crossed)
    assert ok.sum() >= B - 2  # most lanes cross on this easy distribution
    # crossed lanes are HiGHS-tight and at least as good as raw PDHG
    assert gaps[ok].max() < 1e-5
    assert (gaps[ok] <= gaps_raw[ok] + 1e-7).all()


def test_garbage_guess_degrades_gracefully():
    """x == huge nonsense: lanes either still solve (a feasible slack-ish
    basis is a valid cold start) or report crossed == False; no lane may
    return a wrong OPTIMAL."""
    B, m, n = 4, 12, 18
    c, G, h = random_inequality_lps(B, m, n, seed=5)
    c, G, h = jnp.asarray(c), jnp.asarray(G), jnp.asarray(h)
    x_bad = jnp.full((B, n), 1e6, G.dtype)
    res, crossed = crossover_batch_canonical(c, G, h, x_bad, maxiters=400,
                                             cfg=CFG)
    ref = _highs(c, G, h)
    ok = np.asarray(crossed)
    gaps = np.abs(np.asarray(res.cost) - ref) / np.maximum(1, np.abs(ref))
    assert (gaps[ok] < 1e-4).all()  # whatever crossed must be truly optimal
    assert np.isfinite(np.asarray(res.cost)[ok]).all()


def test_uncrossed_lane_keeps_pdhg_answer():
    """Force a bad guess on one lane by zeroing its PDHG budget."""
    B, m, n = 4, 16, 24
    c, G, h = random_inequality_lps(B, m, n, seed=9)
    c, G, h = jnp.asarray(c), jnp.asarray(G), jnp.asarray(h)
    res, crossed = pdhg_crossover_batch_canonical(
        c, G, h, pdhg_maxiters=10, cfg=CFG  # PDHG far from converged
    )
    # regardless of how many lanes crossed, every reported cost is finite
    # and statuses are from the documented taxonomy
    assert np.isfinite(np.asarray(res.cost)).all()
    assert set(np.asarray(res.status).tolist()) <= set(range(10))


def test_ipm_crossover_dual_cleanup_crosses_all_lanes():
    """IPM -> crossover with the dual-then-primal cleanup: a primal-
    infeasible basis guess is repaired by dual-simplex pivots instead of
    bailing (round-2 VERDICT item 1; before the cleanup only ~60% of f32
    lanes crossed at m=n=128)."""
    from linprog_tpu.crossover import ipm_crossover_batch_canonical

    B, m, n = 32, 64, 64
    c, G, h = random_inequality_lps(B, m, n, seed=21)
    c, G, h = jnp.asarray(c), jnp.asarray(G), jnp.asarray(h)
    cfg = SolverConfig(polish_pivots=8, pricing="dantzig",
                       refactor_every=128)
    res, crossed = ipm_crossover_batch_canonical(c, G, h, cfg=cfg)
    ok = np.asarray(crossed)
    assert ok.sum() >= int(0.95 * B)
    ref = _highs(c, G, h)
    gaps = np.abs(np.asarray(res.cost) - ref) / np.maximum(1, np.abs(ref))
    assert gaps[ok].max() < 1e-5
    # crossed lanes carry a real basis certificate (all entries >= 0)
    assert (np.asarray(res.basis)[ok] >= 0).all()


def test_crossover_repairs_infeasible_guess_via_dual_pivots():
    """A basis guess that is dual-feasible but primal-INFEASIBLE must be
    repaired (crossed == True), not rejected."""
    B, m, n = 8, 16, 24
    c, G, h = random_inequality_lps(B, m, n, seed=31)
    xstar = np.stack([
        scipy_linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                      method="highs").x
        for i in range(B)
    ])
    # large multiplicative smear: the top-m ranking now picks a wrong,
    # typically primal-infeasible basis on most lanes
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(xstar * rng.uniform(0.3, 3.0, xstar.shape) + 0.05)
    res, crossed = crossover_batch_canonical(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), x0, maxiters=256,
        cfg=CFG,
    )
    ref = _highs(c, G, h)
    ok = np.asarray(crossed)
    assert ok.sum() >= B - 1  # the dual repair recovers (nearly) all lanes
    gaps = np.abs(np.asarray(res.cost) - ref) / np.maximum(1, np.abs(ref))
    assert gaps[ok].max() < 1e-5


def test_magnitude_guess_matches_implicit_ranking_and_shares_compile():
    """The magnitude guess hands crossover the ranking it would compute
    itself: same answers as ``indicator=None`` at the IPM point, and no
    second compile beside the Tapia guess."""
    from linprog_tpu.crossover import ipm_crossover_batch_canonical
    from linprog_tpu.ipm import DEFAULT_IPM_CONFIG, _ipm_canonical_jit

    B, m, n = 4, 10, 14
    c, G, h = (jnp.asarray(a) for a in random_inequality_lps(B, m, n, seed=5))
    ipm_crossover_batch_canonical(c, G, h, crossover_maxiters=64, cfg=CFG)
    before = crossover_batch_canonical._cache_size()
    res, crossed = ipm_crossover_batch_canonical(
        c, G, h, crossover_maxiters=64, cfg=CFG, guess="magnitude")
    assert crossover_batch_canonical._cache_size() == before

    cs = jnp.concatenate([c, jnp.zeros((B, m), c.dtype)], axis=1)
    x = _ipm_canonical_jit(cs, G, h, DEFAULT_IPM_CONFIG).x[:, :n]
    ref, ref_crossed = crossover_batch_canonical(c, G, h, x, maxiters=64,
                                                 cfg=CFG)
    np.testing.assert_array_equal(np.asarray(crossed),
                                  np.asarray(ref_crossed))
    np.testing.assert_array_equal(np.asarray(res.basis)[np.asarray(crossed)],
                                  np.asarray(ref.basis)[np.asarray(crossed)])
