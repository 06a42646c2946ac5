"""Degeneracy and anti-cycling: Beale's classic example.

Beale (1955): with Dantzig's most-negative-reduced-cost rule the simplex
method cycles forever on this LP; Bland's rule provably terminates.  This
pins down exactly the anti-cycling behavior the reference claims for its
Bland implementation but never tests.
"""

import numpy as np
import pytest

from linprog_tpu import PrimalRevisedSimplexSolver, SolverConfig


def beale_lp():
    # min -3/4 x4 + 150 x5 - 1/50 x6 + 6 x7
    # s.t. x1 + 1/4 x4 - 60 x5 - 1/25 x6 + 9 x7 = 0
    #      x2 + 1/2 x4 - 90 x5 - 1/50 x6 + 3 x7 = 0
    #      x3 + x6 = 1
    c = np.array([0, 0, 0, -0.75, 150, -0.02, 6], dtype=np.float64)
    A = np.array(
        [
            [1, 0, 0, 0.25, -60, -1 / 25, 9],
            [0, 1, 0, 0.5, -90, -1 / 50, 3],
            [0, 0, 1, 0, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    b = np.array([0, 0, 1], dtype=np.float64)
    basis = np.array([0, 1, 2])
    return c, A, b, basis


def test_bland_terminates_on_beale():
    c, A, b, basis = beale_lp()
    cfg = SolverConfig(pricing="bland", dtype="float64", opt_tol=1e-9,
                       pivot_tol=1e-12)
    res = PrimalRevisedSimplexSolver(c, A, b, basis, config=cfg).solve(
        maxiters=100
    )
    assert res.optimum
    assert res.cost == pytest.approx(-0.05, abs=1e-9)  # x6 = 1, x3 leaves


def test_dantzig_cycles_on_beale():
    c, A, b, basis = beale_lp()
    cfg = SolverConfig(pricing="dantzig", dtype="float64", opt_tol=1e-9,
                       pivot_tol=1e-12)
    solver = PrimalRevisedSimplexSolver(c, A, b, basis, config=cfg)
    res = solver.solve(maxiters=60)
    # the classic 6-pivot cycle: never converges, objective stuck at 0
    assert not res.optimum
    assert res.iters == 60
    assert res.cost == pytest.approx(0.0, abs=1e-9)


def test_batched_bounded_variable_engine():
    """The bounded engine composes with vmap (per-lane status freeze)."""
    import jax
    import jax.numpy as jnp

    from linprog_tpu import DEFAULT_CONFIG
    from linprog_tpu import bounded as bnd
    from linprog_tpu import status as st

    # Bazaraa ex 5.6 duplicated across lanes with different cost scales
    c = np.array([-2.0, -4.0, -1.0, 0.0, 0.0], dtype=np.float32)
    A = np.array([[2.0, 1.0, 1.0, 1.0, 0.0], [1.0, 1.0, -1.0, 0.0, 1.0]],
                 dtype=np.float32)
    b = np.array([10.0, 4.0], dtype=np.float32)
    lb = np.array([0.0, 0.0, 1.0, 0.0, 0.0], dtype=np.float32)
    ub = np.array([4.0, 6.0, 4.0, 1e6, 1e6], dtype=np.float32)
    var_state = np.array([0, 0, 0, 2, 2], dtype=np.int8)
    B = 4
    scales = jnp.asarray([1.0, 2.0, 0.5, 3.0], jnp.float32)
    cb = scales[:, None] * jnp.asarray(c)
    Ab = jnp.tile(jnp.asarray(A), (B, 1, 1))
    bb = jnp.tile(jnp.asarray(b), (B, 1))
    lbb = jnp.tile(jnp.asarray(lb), (B, 1))
    ubb = jnp.tile(jnp.asarray(ub), (B, 1))

    def solve_one(ci, Ai, bi, lbi, ubi):
        state = bnd.make_bounded_state(
            Ai, bi, lbi, ubi, jnp.asarray([3, 4]), jnp.asarray(var_state)
        )
        state = bnd.run_bounded(ci, Ai, bi, lbi, ubi, state, 100, DEFAULT_CONFIG)
        return bnd.expand_bounded_bfs(state, lbi, ubi), state.status

    xs, statuses = jax.vmap(solve_one)(cb, Ab, bb, lbb, ubb)
    assert (np.asarray(statuses) == st.OPTIMAL).all()
    expected = np.array([2 / 3, 6.0, 8 / 3, 0.0, 0.0])
    for i in range(B):  # scaling c does not move the argmin
        assert np.allclose(np.asarray(xs)[i], expected, atol=1e-3)


def _beale_batch(B=3):
    import jax
    import jax.numpy as jnp

    from linprog_tpu import engine

    c, A, b, basis = beale_lp()
    cb = jnp.tile(jnp.asarray(c, jnp.float32), (B, 1))
    Ab = jnp.tile(jnp.asarray(A, jnp.float32), (B, 1, 1))
    bb = jnp.tile(jnp.asarray(b, jnp.float32), (B, 1))
    basb = jnp.tile(jnp.asarray(basis, jnp.int32), (B, 1))
    states = jax.vmap(engine.make_state, in_axes=(0, 0, 0))(Ab, bb, basb)
    allowed = jnp.ones((c.shape[0],), bool)
    return cb, Ab, bb, states, allowed


@pytest.mark.parametrize("pricing,refactor_every", [
    ("dantzig", 64), ("dantzig", 0), ("devex", 64),
])
def test_stall_escalation_breaks_beale_cycle(pricing, refactor_every):
    """Dantzig provably cycles on Beale; with stall_limit the stalled lane
    flips to Bland and terminates OPTIMAL (SURVEY section-5
    failure-detection plan; reference's cycle-safe default is Bland,
    /root/reference/linprog/primal_solvers.py:135-138)."""
    import numpy as _np

    from linprog_tpu import status as st
    from linprog_tpu.engine_batched import run_batched

    cfg = SolverConfig(pricing=pricing, stall_limit=8,
                       refactor_every=refactor_every)
    cb, Ab, bb, states, allowed = _beale_batch()
    out = run_batched(cb, Ab, bb, states, allowed, 200, cfg)
    assert (_np.asarray(out.status) == st.OPTIMAL).all(), _np.asarray(out.status)
    # optimal cost -0.05 at x6 = 1
    cost = _np.einsum(
        "bm,bm->b",
        _np.take_along_axis(_np.asarray(cb), _np.asarray(out.basis), axis=1),
        _np.asarray(out.bfs),
    )
    assert _np.allclose(cost, -0.05, atol=1e-6)


@pytest.mark.parametrize("refactor_every", [0, 16])
def test_stall_limit_zero_preserves_cycling(refactor_every):
    """With stall_limit=0 the legacy behavior (cycle to the iter cap) is
    preserved bit-for-bit -- guards against silently changing pivot paths."""
    import numpy as _np

    from linprog_tpu import status as st
    from linprog_tpu.engine_batched import run_batched

    cfg = SolverConfig(pricing="dantzig", stall_limit=0,
                       refactor_every=refactor_every)
    cb, Ab, bb, states, allowed = _beale_batch()
    out = run_batched(cb, Ab, bb, states, allowed, 60, cfg)
    assert (_np.asarray(out.status) == st.RUNNING).all()
    assert (_np.asarray(out.iters) == 60).all()
