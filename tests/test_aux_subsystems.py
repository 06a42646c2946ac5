"""Auxiliary subsystems: checkpoint/resume, observability, batched general API."""

import numpy as np
import pytest

import jax.numpy as jnp

from linprog_tpu import PrimalRevisedSimplexSolver, SolverConfig
from linprog_tpu import status as st
from linprog_tpu.batch import solve_batch_general, solve_batch_two_phase
from linprog_tpu.checkpoint import load_state, save_state
from linprog_tpu.generators import random_inequality_lps, to_standard_form_batch
from linprog_tpu.observability import solve_report, solution_quality, trace
from tests.problems import PRIMAL_PROBLEMS


def test_checkpoint_roundtrip_and_resume(tmp_path):
    p = PRIMAL_PROBLEMS[0]
    solver = PrimalRevisedSimplexSolver(p.c, p.A, p.b, p.starting_basis)
    solver.solve(maxiters=2)  # partial progress
    path = str(tmp_path / "state.npz")
    save_state(path, solver.state)

    restored = load_state(path)
    assert np.array_equal(np.asarray(restored.basis), solver.basis)
    np.testing.assert_allclose(
        np.asarray(restored.inv_B), solver.inv_basis_matrix, rtol=1e-6
    )

    # resume from the restored state in a fresh solver
    fresh = PrimalRevisedSimplexSolver(p.c, p.A, p.b, restored.basis)
    fresh._state = restored
    res = fresh.solve(maxiters=100)
    assert res.optimum
    assert np.array_equal(np.sort(res.basis), np.sort(p.optimal_basis))


def test_solve_report_and_quality():
    B, m, n = 4, 6, 9
    c, G, h = random_inequality_lps(B, m, n, seed=2)
    cs, As, bs = to_standard_form_batch(c, G, h)
    csj, Asj, bsj = jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs)
    with trace(label="test_solve"):
        res = solve_batch_two_phase(csj, Asj, bsj, 200, 200)
    assert trace.last_elapsed_s is not None
    report = solve_report(res, csj, Asj, bsj)
    assert report["lanes"] == B
    assert report["status_counts"].get("OPTIMAL", 0) == B
    assert report["quality"]["max_primal_residual"] < 1e-3
    assert report["quality"]["max_bound_violation"] < 1e-5

    q = solution_quality(csj, Asj, bsj, res.x)
    assert q["objective"].shape == (B,)


def test_solve_batch_general_heterogeneous():
    problems = [
        # equality-form textbook problem
        {"c": PRIMAL_PROBLEMS[0].c, "A": PRIMAL_PROBLEMS[0].A, "b": PRIMAL_PROBLEMS[0].b},
        # inequality-only problem: min -x1-x2 st x1+x2<=4, x1<=3
        {"c": np.array([-1.0, -1.0]), "G": np.array([[1.0, 1.0], [1.0, 0.0]]),
         "h": np.array([4.0, 3.0])},
        # mixed equality + inequality
        {"c": np.array([-1.0, -2.0, 0.0]), "A": np.array([[1.0, 1.0, 1.0]]),
         "b": np.array([4.0]), "G": np.array([[0.0, 1.0, 0.0]]),
         "h": np.array([2.0])},
    ]
    results = solve_batch_general(problems)
    assert all(r.optimum for r in results)
    p0 = PRIMAL_PROBLEMS[0]
    assert results[0].cost == pytest.approx(
        float(p0.c[p0.optimal_basis] @ p0.optimal_bfs), abs=1e-3
    )
    assert results[1].cost == pytest.approx(-4.0, abs=1e-4)
    assert results[2].cost == pytest.approx(-6.0, abs=1e-4)
    assert results[1].x.shape == (2,)
    assert results[2].x.shape == (3,)


def test_solve_batch_general_flags_infeasible_lane():
    problems = [
        {"c": np.zeros(2), "A": np.array([[-1.0, -1.0]]), "b": np.array([1.0])},
        {"c": np.array([-1.0, -1.0]), "G": np.array([[1.0, 1.0]]),
         "h": np.array([2.0])},
    ]
    results = solve_batch_general(problems)
    assert results[0].status == st.PRIMAL_INFEASIBLE
    assert results[1].optimum


def test_orbax_checkpoint_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from linprog_tpu.checkpoint import load_state_orbax, save_state_orbax

    p = PRIMAL_PROBLEMS[0]
    solver = PrimalRevisedSimplexSolver(p.c, p.A, p.b, p.starting_basis)
    solver.solve(maxiters=2)
    path = str(tmp_path / "orbax_ckpt")
    save_state_orbax(path, solver.state)
    restored = load_state_orbax(path, solver.state)
    np.testing.assert_array_equal(
        np.asarray(restored.basis), np.asarray(solver.state.basis)
    )
    np.testing.assert_allclose(
        np.asarray(restored.inv_B), np.asarray(solver.state.inv_B), rtol=1e-6
    )


def test_pdhg_checkpoint_roundtrip_and_exact_resume(tmp_path):
    """PDHG state checkpoints like the simplex states, and resuming from a
    mid-solve checkpoint reproduces the uninterrupted run exactly (the
    state carries iterates, averages, restart anchors, and omega)."""
    import jax.numpy as jnp

    from linprog_tpu.pdhg import DEFAULT_PDHG_CONFIG, _pdhg_core

    c = jnp.asarray([-1.0, -2.0])
    K = jnp.asarray([[1.0, 1.0], [0.0, 1.0]])
    q = jnp.asarray([4.0, 2.0])
    lb = jnp.zeros(2)
    ub = jnp.full(2, jnp.inf)
    init, run = _pdhg_core(c, K, q, 0, lb, ub, DEFAULT_PDHG_CONFIG)

    mid = run(init(), 256)
    path = str(tmp_path / "pdhg_state")
    save_state(path, mid)
    restored = load_state(path)
    assert type(restored).__name__ == "PDHGState"

    full = run(mid, 100_000)
    resumed = run(restored, 100_000)
    np.testing.assert_array_equal(np.asarray(full.x), np.asarray(resumed.x))
    np.testing.assert_array_equal(
        np.asarray(full.iters), np.asarray(resumed.iters)
    )


def test_pdhg_orbax_checkpoint_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    import jax.numpy as jnp

    from linprog_tpu.checkpoint import load_state_orbax, save_state_orbax
    from linprog_tpu.pdhg import DEFAULT_PDHG_CONFIG, _pdhg_core

    c = jnp.asarray([-1.0, -2.0])
    K = jnp.asarray([[1.0, 1.0], [0.0, 1.0]])
    q = jnp.asarray([4.0, 2.0])
    init, run = _pdhg_core(c, K, q, 0, jnp.zeros(2), jnp.full(2, jnp.inf),
                           DEFAULT_PDHG_CONFIG)
    mid = run(init(), 128)
    path = str(tmp_path / "pdhg_orbax")
    save_state_orbax(path, mid)
    restored = load_state_orbax(path, mid)
    np.testing.assert_array_equal(np.asarray(mid.x), np.asarray(restored.x))
    np.testing.assert_array_equal(np.asarray(mid.omega),
                                  np.asarray(restored.omega))


# ---------------------------------------------------------------------------
# Race-detection analogue (SURVEY section 5): determinism across lane
# permutations + a jax_debug_nans test mode.  A data race has no direct
# analogue in SPMD/XLA; what CAN go wrong is per-lane results depending on
# batch placement (a reduction leaking across lanes) or NaNs flowing
# through "frozen" lanes into live ones.
# ---------------------------------------------------------------------------


def test_lane_permutation_determinism():
    """Solving a permuted batch must give the permuted results, bit-exact:
    no cross-lane leakage anywhere in the two-phase pipeline."""
    B, m, n = 8, 12, 16
    c, G, h = random_inequality_lps(B, m, n, seed=23)
    cs, As, bs = to_standard_form_batch(c, G, h)
    cs, As, bs = jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs)
    cfg = SolverConfig()
    res = solve_batch_two_phase(cs, As, bs, 400, 400, cfg)

    perm = np.random.default_rng(0).permutation(B)
    res_p = solve_batch_two_phase(cs[perm], As[perm], bs[perm], 400, 400, cfg)

    np.testing.assert_array_equal(
        np.asarray(res.cost)[perm], np.asarray(res_p.cost)
    )
    np.testing.assert_array_equal(
        np.asarray(res.basis)[perm], np.asarray(res_p.basis)
    )
    np.testing.assert_array_equal(
        np.asarray(res.iters)[perm], np.asarray(res_p.iters)
    )
    np.testing.assert_array_equal(
        np.asarray(res.status)[perm], np.asarray(res_p.status)
    )


def test_debug_nans_mode_clean_on_healthy_batch():
    """The SURVEY section-5 sanitizer mode: under jax_debug_nans the whole
    two-phase pipeline must run NaN-free on healthy inputs (frozen-lane
    arithmetic must never surface NaN into outputs)."""
    import jax

    B, m, n = 4, 8, 12
    c, G, h = random_inequality_lps(B, m, n, seed=29)
    cs, As, bs = to_standard_form_batch(c, G, h)
    jax.config.update("jax_debug_nans", True)
    try:
        res = solve_batch_two_phase(
            jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), 300, 300,
            SolverConfig(polish_pivots=4),
        )
        assert np.isfinite(np.asarray(res.cost)).all()
        assert (np.asarray(res.status) == st.OPTIMAL).all()
    finally:
        jax.config.update("jax_debug_nans", False)


def test_scaled_cost_optimality_tolerance():
    """|c| ~ 1e6 data: the reference's np.isclose optimality test is
    RELATIVE; an absolute 1e-6 tol churns on pricing noise forever.  Both
    the single-instance engine and the batched XLA path must terminate
    OPTIMAL with the correct relative objective."""
    from scipy.optimize import linprog as scipy_linprog

    from linprog_tpu import SimplexSolver

    B, m, n = 4, 10, 14
    c, G, h = random_inequality_lps(B, m, n, seed=31)
    c = c * 1e6  # badly scaled costs
    ref = [
        scipy_linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                      method="highs").fun
        for i in range(B)
    ]
    # batched XLA path
    cs, As, bs = to_standard_form_batch(c, G, h)
    res = solve_batch_two_phase(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), 500, 500,
        SolverConfig(),
    )
    assert (np.asarray(res.status) == st.OPTIMAL).all()
    gaps = np.abs(np.asarray(res.cost) - ref) / np.maximum(1, np.abs(ref))
    assert gaps.max() < 1e-4
    # single-instance general-form driver
    r0 = SimplexSolver(c[0], G=G[0], h=h[0]).solve(500, 500)
    assert r0.optimum
    assert abs(r0.cost - ref[0]) / max(1, abs(ref[0])) < 1e-4
