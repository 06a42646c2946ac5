"""Bounded-variable primal simplex: ``min c'x  s.t. Ax = b, lb <= x <= ub``.

JAX rebuild of the reference ``BoundedVariablePrimalSimplexSolver``
(reference ``linprog/special_solvers.py:94-343``).  The reference tracks
nonbasic-at-lower/upper-bound *index sets* grown and shrunk with
``np.delete``/``np.append`` -- dynamic shapes that cannot exist under jit.
Here every variable carries a status in a static ``var_state[n]`` vector
(``AT_LB`` / ``AT_UB`` / ``BASIC``) and the solver step is fully branchless:

* bound-aware pricing with sign-flipped reduced costs for at-upper-bound
  variables (reference ``special_solvers.py:177-199``);
* Dantzig entering rule ``argmax(reduced_costs)`` (reference
  ``special_solvers.py:208-211``);
* three-way ratio test -- basic drops to lb (gamma1), basic hits ub
  (gamma2), entering variable traverses to its opposite bound (gamma3) --
  as three masked reductions (reference ``special_solvers.py:239-331``);
* bound flip without basis change when ``gamma3 <= delta``
  (reference ``special_solvers.py:264-268``);
* unbounded when no finite step exists.  (Deviation: the reference raises
  unbounded whenever ``min(gamma1, gamma2) == inf`` even if a finite bound
  flip ``gamma3`` exists, ``special_solvers.py:256-257``; this engine only
  reports unbounded when *no* finite step of any kind exists, which is the
  mathematically correct test.)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from . import engine
from . import status as st
from .config import SolverConfig
from .utils import primal_simplex_div

AT_LB = jnp.int8(0)
AT_UB = jnp.int8(1)
BASIC = jnp.int8(2)


class BoundedState(NamedTuple):
    """Solver state for the bounded-variable engine."""

    basis: jax.Array  # i32[m]
    inv_B: jax.Array  # f[m, m]
    bfs: jax.Array  # f[m] -- values of basic variables
    var_state: jax.Array  # i8[n] -- AT_LB / AT_UB / BASIC
    iters: jax.Array  # i32[]
    status: jax.Array  # i32[]


def nonbasic_values(var_state, lb, ub):
    """x_N: lb for AT_LB vars, ub for AT_UB vars, 0 on basic positions."""
    return jnp.where(
        var_state == AT_LB, lb, jnp.where(var_state == AT_UB, ub, jnp.zeros_like(lb))
    )


def compute_bfs(A, b, inv_B, var_state, lb, ub):
    """``x_B = inv_B @ (b - A_N x_N)`` (reference ``special_solvers.py:169-175``)."""
    x_n = nonbasic_values(var_state, lb, ub)
    return inv_B @ (b - A @ x_n)


def make_bounded_state(A, b, lb, ub, basis, var_state) -> BoundedState:
    basis = jnp.asarray(basis, jnp.int32)
    inv_B = jnp.linalg.inv(jnp.take(A, basis, axis=1))
    bfs = compute_bfs(A, b, inv_B, var_state, lb, ub)
    return BoundedState(
        basis=basis,
        inv_B=inv_B,
        bfs=bfs,
        var_state=jnp.asarray(var_state, jnp.int8),
        iters=jnp.zeros((), jnp.int32),
        status=jnp.zeros((), jnp.int32),
    )


def bounded_reduced_costs(c, A, state: BoundedState):
    """Bound-aware reduced costs: ``z - c`` for AT_LB, ``c - z`` for AT_UB,
    0 for basic (reference ``special_solvers.py:177-199``).  Positive means
    improving under the Dantzig ``argmax`` rule either way."""
    z = (jnp.take(c, state.basis) @ state.inv_B) @ A
    zc = z - c
    rc = jnp.where(state.var_state == AT_UB, -zc, zc)
    return jnp.where(state.var_state == BASIC, jnp.zeros_like(rc), rc)


def bounded_step(c, A, b, lb, ub, state: BoundedState, cfg: SolverConfig,
                 allowed=None) -> BoundedState:
    """One bounded-variable simplex iteration, fully branchless.

    ``allowed`` (optional boolean[n]) masks columns permitted to ENTER --
    used by the two-phase driver to lock Phase-I artificials out of
    Phase II (same contract as :func:`engine.primal_step`).
    """
    rc = bounded_reduced_costs(c, A, state)
    if allowed is not None:
        rc = jnp.where(allowed, rc, -jnp.inf)
    best = jnp.max(rc)
    not_optimal = best > cfg.opt_tol
    enter = jnp.argmax(rc)

    # +1 if entering variable increases (from lb), -1 if it decreases (from ub)
    sigma = jnp.where(state.var_state[enter] == AT_LB, 1.0, -1.0).astype(c.dtype)
    d = state.inv_B @ jnp.take(A, enter, axis=1)
    sd = sigma * d

    lb_B = jnp.take(lb, state.basis)
    ub_B = jnp.take(ub, state.basis)
    gammas1 = primal_simplex_div(state.bfs - lb_B, sd, cfg.pivot_tol)
    gammas2 = primal_simplex_div(ub_B - state.bfs, -sd, cfg.pivot_tol)
    g1 = jnp.min(gammas1)
    g2 = jnp.min(gammas2)
    gamma3 = ub[enter] - lb[enter]
    delta = jnp.minimum(g1, g2)

    unbounded = not_optimal & jnp.isinf(delta) & jnp.isinf(gamma3)
    bound_flip = not_optimal & ~unbounded & (gamma3 <= delta)
    do_pivot = not_optimal & ~unbounded & ~bound_flip

    # --- bound-flip candidate: entering var jumps to its opposite bound ----
    flipped_vs = state.var_state.at[enter].set(
        jnp.where(state.var_state[enter] == AT_LB, AT_UB, AT_LB).astype(jnp.int8)
    )

    # --- pivot candidate ---------------------------------------------------
    leave_to_lb = g1 < g2  # leaving basic variable lands on its lower bound
    leave = jnp.where(leave_to_lb, jnp.argmin(gammas1), jnp.argmin(gammas2))
    leaving_col = state.basis[leave]
    pivot_vs = state.var_state.at[leaving_col].set(
        jnp.where(leave_to_lb, AT_LB, AT_UB).astype(jnp.int8)
    )
    pivot_vs = pivot_vs.at[enter].set(BASIC)
    # masked eta update: zeroed eta column makes the rank-1 update a no-op
    # when not pivoting (avoids a full O(m^2) select; see engine._masked_pivot)
    d_l = d[leave]
    safe = jnp.where(d_l == 0, jnp.ones_like(d_l), d_l)
    u = -d / safe
    u = u.at[leave].set(1.0 / safe - 1.0)
    u = jnp.where(do_pivot, u, jnp.zeros_like(u))
    inv_B = state.inv_B + jnp.outer(u, state.inv_B[leave])
    basis = jnp.where(
        do_pivot,
        state.basis.at[leave].set(jnp.asarray(enter, jnp.int32)),
        state.basis,
    )

    # --- incremental bfs (O(m), replaces the reference's from-scratch
    # x_B = inv_B (b - A_N x_N) chain, special_solvers.py:169-175):
    # every basic moves by -step * sigma * d; on a true pivot the leaving
    # slot then holds the entering variable's new value
    step_len = jnp.where(bound_flip, gamma3, jnp.where(do_pivot, delta, 0.0))
    bfs_moved = state.bfs - step_len * sd
    enter_val = (
        jnp.where(sigma > 0, jnp.take(lb, enter), jnp.take(ub, enter))
        + sigma * delta
    )
    bfs = jnp.where(
        do_pivot, bfs_moved.at[leave].set(enter_val), bfs_moved
    )
    var_state = jnp.where(do_pivot, pivot_vs, jnp.where(bound_flip, flipped_vs, state.var_state))

    new_status = jnp.where(
        ~not_optimal,
        st.OPTIMAL,
        jnp.where(unbounded, st.PRIMAL_UNBOUNDED, st.RUNNING),
    )
    return BoundedState(
        basis=basis,
        inv_B=inv_B,
        bfs=bfs,
        var_state=var_state,
        iters=state.iters + 1,
        status=jnp.asarray(new_status, jnp.int32),
    )


def refactorize_bounded(A, b, lb, ub, state: BoundedState) -> BoundedState:
    """Fresh ``inv_B`` + exact bfs (bounds drift control)."""
    inv_B = jnp.linalg.inv(jnp.take(A, state.basis, axis=1))
    bfs = compute_bfs(A, b, inv_B, state.var_state, lb, ub)
    ok = jnp.all(jnp.isfinite(inv_B)) & jnp.all(jnp.isfinite(bfs))
    fresh = state._replace(inv_B=inv_B, bfs=bfs)
    guarded = state._replace(status=jnp.asarray(st.NUMERICAL_ERROR, jnp.int32))
    return engine.tree_select(ok, fresh, guarded)


def run_bounded(c, A, b, lb, ub, state: BoundedState, maxiters,
                cfg: SolverConfig, allowed=None) -> BoundedState:
    maxiters = jnp.asarray(maxiters, jnp.int32)

    def cond(s: BoundedState):
        return (s.status == st.RUNNING) & (s.iters < maxiters)

    def body(s: BoundedState):
        return bounded_step(c, A, b, lb, ub, s, cfg, allowed)

    if cfg.refactor_every > 0:
        chunk = jnp.asarray(cfg.refactor_every, jnp.int32)

        def outer_body(s: BoundedState):
            hi = jnp.minimum(s.iters + chunk, maxiters)
            s = lax.while_loop(lambda t: cond(t) & (t.iters < hi), body, s)
            fresh = refactorize_bounded(A, b, lb, ub, s)
            return engine.tree_select(s.status == st.RUNNING, fresh, s)

        return lax.while_loop(cond, outer_body, state)
    return lax.while_loop(cond, body, state)


@partial(jax.jit, static_argnames=("cfg",))
def run_bounded_jit(c, A, b, lb, ub, state, maxiters, cfg: SolverConfig):
    return run_bounded(c, A, b, lb, ub, state, maxiters, cfg)


def expand_bounded_bfs(state: BoundedState, lb, ub) -> jax.Array:
    """Full x: bound values for nonbasic vars, bfs scattered on basis
    (reference ``special_solvers.py:201-206``)."""
    x = nonbasic_values(state.var_state, lb, ub)
    return x.at[state.basis].set(state.bfs)


@partial(jax.jit, static_argnames=("cfg",))
def solve_bounded_two_phase(c, A, b, lb, ub, maxiters1, maxiters2,
                            cfg: SolverConfig):
    """Two-phase bounded-variable solve: no starting basis needed.

    ``min c'x  s.t.  Ax = b, lb <= x <= ub`` with ``b >= 0`` (preprocessing
    sign fix) and ``lb == 0`` expected (the general-form driver shifts
    finite lower bounds into the rhs); finite ``ub`` entries are handled
    NATIVELY by the bounded engine instead of materializing one
    ``x_j + s = ub_j`` row+column each (the reference's approach,
    ``/root/reference/linprog/preprocessing.py:30-69``, which inflates
    ``m`` and with it the measured-dominant Phase-I pivot count).

    Phase I appends ``m`` artificial columns (slack-crash start: existing
    unit columns serve their row where possible); Phase II pins the
    artificials to ``ub = 0`` -- a basic artificial is then forced to
    leave at the first pivot that would move it, and nonbasic artificials
    are locked out of entering by the ``allowed`` mask.

    Returns ``(x, basis, iters_total, status, y)`` with ``x`` over the
    structural columns of ``A``, ``y = c_B inv_B`` the standard-form duals
    at the terminal basis (Phase-I duals -- a Farkas certificate -- for
    infeasible instances).
    """
    m, n = A.shape
    dt = A.dtype
    A1 = jnp.concatenate([A, jnp.eye(m, dtype=dt)], axis=1)
    c1 = jnp.concatenate([jnp.zeros(n, dt), jnp.ones(m, dt)])
    lb1 = jnp.concatenate([lb, jnp.zeros(m, dt)])
    ub1 = jnp.concatenate([ub, jnp.full(m, jnp.inf, dt)])

    # slack-crash start (the plain engine's unit-column detection with one
    # EXTRA condition: the crash value ``b_i / pivot`` must respect the
    # column's own bounds, so only ub = +inf columns qualify -- a bounded
    # slack crashed above its ub would make the start bound-infeasible):
    # nonbasic structural vars sit AT_LB = 0, so x_N contributes nothing
    col_abs_sum = jnp.sum(jnp.abs(A), axis=0)
    other_mass = col_abs_sum[None, :] - jnp.abs(A)
    unit = (A > 0) & (other_mass == 0.0) & jnp.isinf(ub)[None, :]
    has_unit = jnp.any(unit, axis=1)
    unit_col = jnp.argmax(unit, axis=1).astype(jnp.int32)
    basis0 = jnp.where(
        has_unit, unit_col, jnp.arange(n, n + m, dtype=jnp.int32)
    )
    pivot_vals = jnp.where(
        has_unit, A[jnp.arange(m), unit_col], jnp.ones_like(b)
    )
    inv_diag = 1.0 / pivot_vals
    var_state = jnp.full((n + m,), AT_LB, jnp.int8).at[basis0].set(BASIC)
    state = BoundedState(
        basis=basis0, inv_B=jnp.diag(inv_diag).astype(dt),
        bfs=jnp.asarray(b) * inv_diag, var_state=var_state,
        iters=jnp.zeros((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )
    state = run_bounded(c1, A1, b, lb1, ub1, state, maxiters1, cfg)

    art_cost = jnp.sum(jnp.where(state.basis >= n, state.bfs, 0.0))
    scale = jnp.maximum(1.0, jnp.max(jnp.abs(b))) * m
    infeasible = (state.status == st.OPTIMAL) & (
        art_cost > cfg.feas_tol * scale
    )
    p1_stalled = state.status == st.RUNNING
    phase1_iters = state.iters
    y_farkas = jnp.take(c1, state.basis) @ state.inv_B

    # ---- Phase II: artificials pinned to 0 and locked out of pricing ------
    c2 = jnp.concatenate([c, jnp.zeros(m, dt)])
    ub2 = ub1.at[n:].set(0.0)
    allowed2 = jnp.arange(n + m) < n
    status = jnp.where(
        infeasible,
        st.PRIMAL_INFEASIBLE,
        jnp.where(p1_stalled, st.ITER_LIMIT, st.RUNNING),
    ).astype(jnp.int32)
    state = state._replace(status=status, iters=jnp.zeros((), jnp.int32))
    state = run_bounded(c2, A1, b, lb1, ub2, state, maxiters2, cfg,
                        allowed=allowed2)

    # exact terminal bfs (same accuracy pass as the plain two-phase driver)
    inv_fresh = jnp.linalg.inv(jnp.take(A1, state.basis, axis=1))
    bfs_fresh = compute_bfs(A1, b, inv_fresh, state.var_state, lb1, ub2)
    ok = jnp.all(jnp.isfinite(inv_fresh)) & jnp.all(jnp.isfinite(bfs_fresh))
    state = engine.tree_select(
        ok,
        state._replace(inv_B=inv_fresh, bfs=bfs_fresh),
        state._replace(status=jnp.asarray(st.NUMERICAL_ERROR, jnp.int32)),
    )

    x_full = expand_bounded_bfs(state, lb1, ub2)
    y = jnp.take(c2, state.basis) @ state.inv_B
    y = jnp.where(infeasible, y_farkas, y)
    status = jnp.where(
        state.status == st.RUNNING, st.ITER_LIMIT, state.status
    ).astype(jnp.int32)
    return (
        x_full[:n], state.basis, phase1_iters + state.iters, status, y,
    )
