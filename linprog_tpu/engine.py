"""Functional revised-simplex engine.

This replaces the reference's four-class inheritance tree
(``PrimalNaiveSimplexSolver`` -> ``PrimalRevisedSimplexSolver`` ->
``DualNaiveSimplexSolver`` -> diamond ``DualRevisedSimplexSolver``;
reference ``linprog/primal_solvers.py:10-263``, ``linprog/dual_solvers.py:9-120``)
with ONE functional engine: an explicit :class:`SimplexState` pytree, a
branchless ``step`` function per iteration mode (primal / dual), and a
``lax.while_loop`` driver.  Everything is shape-static and select-based so the
engine vmaps cleanly over a batch of LP instances and pjit-shards over a
device mesh.

Algorithmic parity notes (all verified against the reference):

* Pricing: ``r = c - (c_B @ inv_B) @ A`` with basis entries zeroed
  (reference ``primal_solvers.py:59-66``) -- one GEMV chain.
* Bland's rule: first column with ``r_j < -opt_tol``
  (reference ``np.argmax(reduced_costs < 0)``, ``primal_solvers.py:135-138``;
  ``jnp.argmax`` over booleans has identical first-True semantics).
* Primal ratio test: ``theta = bfs / d`` over ``d > 0``, first argmin
  (reference ``primal_solvers.py:149-167`` + ``utils.py:5-10``).
* Unboundedness: no positive direction entry (reference
  ``primal_solvers.py:144-147``) -> status ``PRIMAL_UNBOUNDED``.
* Eta update: the reference materializes an m-by-m eta matrix and runs a full
  m^3 matmul per pivot (``primal_solvers.py:217-253``); here it is the
  mathematically identical rank-1 update ``inv_B += u (x) inv_B[leave, :]``,
  O(m^2) and HBM-bandwidth-bound instead of FLOP-bound.
* Dual iteration: leaving row = first ``bfs < -feas_tol``; dual ratio test
  ``-r / u`` over ``u < 0`` (reference ``dual_solvers.py:9-108``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig

# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


class SimplexState(NamedTuple):
    """Explicit solver state pytree.

    This is the checkpointable / resumable unit: the reference achieves
    resumability by keeping ``basis``/``inv_basis_matrix``/``bfs`` live on the
    instance between ``solve(maxiters=1)`` calls (used by its Bland-sequence
    test); here the same state is an explicit value passed in and out of the
    jitted step, so it can be saved with orbax/np.save trivially.
    """

    basis: jax.Array  # i32[m] -- column of A at each basis position
    inv_B: jax.Array  # f[m, m] -- inverse of A[:, basis]
    bfs: jax.Array  # f[m]    -- current basic feasible solution (x_B)
    iters: jax.Array  # i32[]  -- loop-entry counter (reference `counter`)
    status: jax.Array  # i32[] -- status code (st.*)


def tree_select(pred, on_true, on_false):
    """Branchless per-leaf select (works under vmap; `pred` is a scalar bool)."""
    return jax.tree.map(lambda t, f: jnp.where(pred, t, f), on_true, on_false)


def in_basis_mask(basis: jax.Array, n: int) -> jax.Array:
    """Boolean[n] mask of columns currently in the basis."""
    return jnp.zeros((n,), jnp.bool_).at[basis].set(True)


def make_state(A, b, basis, status: int = st.RUNNING) -> SimplexState:
    """Initialize state from a starting basis (computes ``inv(A[:, basis])``).

    The only full inversion in the eta-update mode, mirroring the reference's
    one-time ``np.linalg.inv`` at ``primal_solvers.py:37``.
    """
    basis = jnp.asarray(basis, jnp.int32)
    inv_B = jnp.linalg.inv(jnp.take(A, basis, axis=1))
    bfs = inv_B @ b
    # a singular basis matrix yields inf/nan factors (jnp.linalg.inv does
    # not raise); mark the lane NUMERICAL_ERROR so it freezes immediately
    ok = jnp.all(jnp.isfinite(inv_B))
    return SimplexState(
        basis=basis,
        inv_B=inv_B,
        bfs=bfs,
        iters=jnp.zeros((), jnp.int32),
        status=jnp.where(ok, status, st.NUMERICAL_ERROR).astype(jnp.int32),
    )


def slack_crash_state(A, b, n: int) -> SimplexState:
    """Crash basis: use existing unit columns of ``A`` where possible.

    For each row ``i``, if some structural column ``j < n`` equals ``+e_i``
    (a slack column of an untouched ``Gx <= h`` row), take it into the basis;
    otherwise fall back to the artificial ``n + i``.  Either way the basis
    matrix is the identity, so ``inv_B = I`` and ``bfs = b`` with no
    inversion -- but Phase I now only has to drive out artificials for the
    rows that actually need them (typically the sign-flipped rows), roughly
    halving Phase-I pivots on ``Gx <= h`` instances.

    ``A`` here is the Phase-I matrix ``[A_struct | I]`` with ``n`` structural
    columns.  Requires ``b >= 0`` (preprocessing's sign fix).
    """
    m = b.shape[0]
    struct = A[:, :n]
    col_abs_sum = jnp.sum(jnp.abs(struct), axis=0)  # [n]
    # unit-like[i, j]: column j's only (significant) entry is A[i, j] > 0.
    # Accepts POSITIVELY SCALED unit columns too (equilibration rescales
    # slack columns away from exactly 1).
    entry = struct  # [m, n]
    other_mass = col_abs_sum[None, :] - jnp.abs(entry)
    # EXACT zero off-pivot mass required: Ruiz equilibration scales rows/
    # columns multiplicatively, so true slack columns keep exact zeros;
    # accepting near-unit columns (old 1e-6 tolerance) silently produced a
    # wrong inv_B/bfs for such columns (diagonal assumption)
    unit = (entry > 0) & (other_mass == 0.0)
    has_unit = jnp.any(unit, axis=1)  # [m]
    unit_col = jnp.argmax(unit, axis=1).astype(jnp.int32)  # first per row
    basis = jnp.where(
        has_unit, unit_col, jnp.arange(n, n + m, dtype=jnp.int32)
    )
    # basis matrix is diagonal: pivot value per row (1 for artificials)
    pivot_vals = jnp.where(
        has_unit, struct[jnp.arange(m), unit_col], jnp.ones_like(b)
    )
    inv_diag = 1.0 / pivot_vals
    return SimplexState(
        basis=basis,
        inv_B=jnp.diag(inv_diag).astype(b.dtype),
        bfs=jnp.asarray(b) * inv_diag,
        iters=jnp.zeros((), jnp.int32),
        status=jnp.zeros((), jnp.int32),
    )


def artificial_state(b, n: int) -> SimplexState:
    """State for an all-artificial basis ``[A | I]`` (Phase I start).

    ``inv_B = I`` and ``bfs = b`` exactly; no inversion needed
    (vs reference ``special_solvers.py:48-53`` which re-inverts).
    Requires ``b >= 0`` (guaranteed by preprocessing's sign fix).
    """
    m = b.shape[0]
    return SimplexState(
        basis=jnp.arange(n, n + m, dtype=jnp.int32),
        inv_B=jnp.eye(m, dtype=b.dtype),
        bfs=jnp.asarray(b),
        iters=jnp.zeros((), jnp.int32),
        status=jnp.zeros((), jnp.int32),
    )


# ---------------------------------------------------------------------------
# Pricing / checks
# ---------------------------------------------------------------------------


def duals(c, state: SimplexState) -> jax.Array:
    """Simplex multipliers ``y = c_B @ inv_B`` (one GEMV)."""
    return jnp.take(c, state.basis) @ state.inv_B


def reduced_costs(c, A, state: SimplexState) -> jax.Array:
    """``r = c - y @ A`` with basis entries forced to exactly 0.

    Parity: reference ``primal_solvers.py:59-66`` (zeroing "avoids numerical
    errors" per the reference comment; it also makes optimality == "no
    eligible entering column").
    """
    r = c - duals(c, state) @ A
    return jnp.where(in_basis_mask(state.basis, c.shape[0]), jnp.zeros_like(r), r)


def basis_is_primal_feasible(A, b, basis, tol: float) -> jax.Array:
    inv_B = jnp.linalg.inv(jnp.take(A, basis, axis=1))
    return jnp.all(inv_B @ b >= -tol)


def basis_is_dual_feasible(c, A, basis, tol: float) -> jax.Array:
    inv_B = jnp.linalg.inv(jnp.take(A, basis, axis=1))
    y = jnp.take(c, jnp.asarray(basis, jnp.int32)) @ inv_B
    return jnp.all(y @ A <= c + tol)


def expand_bfs(state: SimplexState, n: int) -> jax.Array:
    """Scatter ``bfs`` into the full-length x (reference ``_get_bfs_expanded``)."""
    return jnp.zeros((n,), state.bfs.dtype).at[state.basis].set(state.bfs)


def current_cost(c, state: SimplexState) -> jax.Array:
    return jnp.take(c, state.basis) @ state.bfs


# ---------------------------------------------------------------------------
# Pivot machinery
# ---------------------------------------------------------------------------


def eta_update(inv_B, bfs, d, leave):
    """Product-form-of-the-inverse update as a rank-1 outer-product.

    With eta column ``u_i = -d_i/d_l (i != l)``, ``u_l = 1/d_l - 1``:
    ``E @ M == M + u (x) M[l, :]`` -- identical to the reference's dense
    ``E @ inv_B`` (``primal_solvers.py:217-253``) at O(m^2) instead of O(m^3).
    """
    d_l = d[leave]
    safe = jnp.where(d_l == 0, jnp.ones_like(d_l), d_l)
    u = -d / safe
    u = u.at[leave].set(1.0 / safe - 1.0)
    inv_B = inv_B + jnp.outer(u, inv_B[leave])
    bfs = bfs + u * bfs[leave]
    return inv_B, bfs


def apply_pivot(
    A, b, state: SimplexState, leave, enter, cfg: SolverConfig, d=None
) -> SimplexState:
    """Pivot ``basis[leave] <- enter`` and update factors per ``cfg.update``.

    ``d`` may pass in the already-computed direction ``inv_B @ A[:, enter]``
    (the ratio test needs it anyway) to avoid a second pass over ``inv_B``.
    """
    if cfg.update == "naive":
        basis = state.basis.at[leave].set(jnp.asarray(enter, jnp.int32))
        inv_B = jnp.linalg.inv(jnp.take(A, basis, axis=1))
        bfs = inv_B @ b
    else:
        if d is None:
            d = state.inv_B @ jnp.take(A, enter, axis=1)
        inv_B, bfs = eta_update(state.inv_B, state.bfs, d, leave)
        basis = state.basis.at[leave].set(jnp.asarray(enter, jnp.int32))
    return state._replace(basis=basis, inv_B=inv_B, bfs=bfs)


def _masked_pivot(
    A, b, state: SimplexState, leave, enter, d, do_pivot, cfg: SolverConfig
) -> SimplexState:
    """Pivot iff ``do_pivot`` WITHOUT a full-state select.

    A where-select on ``inv_B`` costs an extra full pass over the O(m^2)
    factor, several times the rank-1 update itself.  For
    the eta path the same effect is free: zero the eta column ``u`` when
    ``do_pivot`` is false and the rank-1 update becomes a no-op.  Only the
    O(m) leaves (basis, bfs) need real selects.  The naive path keeps the
    select (it is the small-problem oracle, not the hot path).
    """
    if cfg.update == "naive":
        pivoted = apply_pivot(A, b, state, leave, enter, cfg)
        return tree_select(do_pivot, pivoted, state)

    d_l = d[leave]
    safe = jnp.where(jnp.abs(d_l) > 0, d_l, jnp.ones_like(d_l))
    u = -d / safe
    u = u.at[leave].set(1.0 / safe - 1.0)
    u = jnp.where(do_pivot, u, jnp.zeros_like(u))
    inv_B = state.inv_B + jnp.outer(u, state.inv_B[leave])
    bfs = state.bfs + u * state.bfs[leave]
    basis = jnp.where(
        do_pivot,
        state.basis.at[leave].set(jnp.asarray(enter, jnp.int32)),
        state.basis,
    )
    return state._replace(basis=basis, inv_B=inv_B, bfs=bfs)


def refactorize(A, b, state: SimplexState) -> SimplexState:
    """Recompute ``inv_B`` and ``bfs`` from scratch (drift control)."""
    inv_B = jnp.linalg.inv(jnp.take(A, state.basis, axis=1))
    return state._replace(inv_B=inv_B, bfs=inv_B @ b)


# ---------------------------------------------------------------------------
# Iteration steps (branchless; safe under vmap)
# ---------------------------------------------------------------------------


def primal_step(c, A, b, allowed, state: SimplexState, cfg: SolverConfig) -> SimplexState:
    """One primal simplex iteration: price -> check -> enter -> ratio -> pivot.

    Mirrors the loop body of reference ``primal_solvers.py:176-209`` with all
    control flow converted to selects so a batch never serializes.
    ``allowed`` is a boolean[n] mask of columns permitted to enter (used by the
    restricted-primal of the primal-dual algorithm and to lock out
    artificials in composite Phase II).
    """
    # optimality tolerance scaled by the cost magnitude: the reference's
    # check is np.isclose (rtol 1e-5 RELATIVE to the reduced-cost magnitude,
    # reference primal_solvers.py:140-142); an absolute tol on |c| ~ 1e6
    # data would churn forever on pricing noise the reference calls optimal.
    # max(1, |c|_inf) preserves the absolute behavior on O(1) data (every
    # pivot-path parity test) and the reference semantics on scaled data.
    r = reduced_costs(c, A, state)
    tol = cfg.opt_tol * jnp.maximum(1.0, jnp.max(jnp.abs(c)))
    eligible = (r < -tol) & allowed
    any_elig = jnp.any(eligible)

    if cfg.pricing == "devex":
        raise ValueError(
            "pricing='devex' is not implemented on the single-instance "
            "engine -- use pricing='dantzig'/'bland' here (devex runs on "
            "the batched primal loop, engine_batched.run_batched)"
        )
    if cfg.pricing == "dantzig":
        enter = jnp.argmin(jnp.where(eligible, r, jnp.inf))
    else:  # bland: first eligible column
        enter = jnp.argmax(eligible)

    d = state.inv_B @ jnp.take(A, enter, axis=1)
    pos = d > cfg.pivot_tol
    unbounded = any_elig & ~jnp.any(pos)

    # bfs clamped at 0: refactorization can leave ~-1e-7 noise on degenerate
    # basics, and a negative ratio would hijack the argmin toward rows with
    # tiny pivot elements (numerically singular bases)
    bfs_nn = jnp.maximum(state.bfs, 0.0)
    theta = jnp.where(pos, bfs_nn / jnp.where(pos, d, jnp.ones_like(d)), jnp.inf)
    leave = jnp.argmin(theta)  # first-min == Bland tie-break, matches np.argmin

    do_pivot = any_elig & ~unbounded
    out = _masked_pivot(A, b, state, leave, enter, d, do_pivot, cfg)

    new_status = jnp.where(
        ~any_elig,
        st.OPTIMAL,
        jnp.where(unbounded, st.PRIMAL_UNBOUNDED, st.RUNNING),
    )
    return out._replace(
        status=jnp.asarray(new_status, jnp.int32), iters=state.iters + 1
    )


def dual_step(c, A, b, allowed, state: SimplexState, cfg: SolverConfig) -> SimplexState:
    """One dual simplex iteration (reference ``dual_solvers.py:82-108``).

    Leaving row: first ``bfs < -feas_tol`` (reference ``argmax(bfs < 0)``).
    Dual direction: row ``leave`` of ``inv_B @ A`` with basis entries zeroed.
    Dual unboundedness (== primal infeasibility): no negative direction entry.
    Dual ratio test: ``-r / u`` over ``u < 0``, first argmin.
    """
    n = c.shape[0]
    neg = state.bfs < -cfg.feas_tol
    any_neg = jnp.any(neg)
    if cfg.pricing == "devex":
        raise ValueError(
            "pricing='devex' has no dual-engine implementation anywhere "
            "(the reference rule is a primal pricing rule); use "
            "pricing='dantzig'/'bland' for dual solves"
        )
    if cfg.pricing == "dantzig":  # most-infeasible row
        leave = jnp.argmin(state.bfs)
    else:  # bland: first infeasible row (reference rule)
        leave = jnp.argmax(neg)

    u = state.inv_B[leave] @ A
    u = jnp.where(in_basis_mask(state.basis, n), jnp.zeros_like(u), u)
    cand = (u < -cfg.pivot_tol) & allowed
    unbounded = any_neg & ~jnp.any(cand)

    r = reduced_costs(c, A, state)
    theta = jnp.where(cand, -r / jnp.where(cand, u, -jnp.ones_like(u)), jnp.inf)
    enter = jnp.argmin(theta)

    d = state.inv_B @ jnp.take(A, enter, axis=1)
    do_pivot = any_neg & ~unbounded
    out = _masked_pivot(A, b, state, leave, enter, d, do_pivot, cfg)

    new_status = jnp.where(
        ~any_neg,
        st.OPTIMAL,
        jnp.where(unbounded, st.DUAL_UNBOUNDED, st.RUNNING),
    )
    return out._replace(
        status=jnp.asarray(new_status, jnp.int32), iters=state.iters + 1
    )


_STEP_FNS = {"primal": primal_step, "dual": dual_step}


# ---------------------------------------------------------------------------
# Loop driver
# ---------------------------------------------------------------------------


def run(
    c,
    A,
    b,
    state: SimplexState,
    allowed,
    maxiters,
    cfg: SolverConfig = DEFAULT_CONFIG,
    mode: str = "primal",
) -> SimplexState:
    """Drive ``step`` under ``lax.while_loop`` until terminal or ``maxiters``.

    ``maxiters`` may be a traced scalar (no recompile when it changes).
    Matches the reference loop semantics exactly: the counter increments on
    every loop entry including the one that detects optimality
    (reference ``primal_solvers.py:189-192``), and hitting ``maxiters``
    leaves status ``RUNNING`` (soft fail -> ``optimum=False``).
    """
    step = _STEP_FNS[mode]
    maxiters = jnp.asarray(maxiters, jnp.int32)

    def cond(s: SimplexState):
        return (s.status == st.RUNNING) & (s.iters < maxiters)

    def body(s: SimplexState):
        return step(c, A, b, allowed, s, cfg)

    if cfg.refactor_every > 0 and cfg.update == "eta":
        chunk = jnp.asarray(cfg.refactor_every, jnp.int32)

        def outer_cond(s: SimplexState):
            return cond(s)

        def outer_body(s: SimplexState):
            hi = jnp.minimum(s.iters + chunk, maxiters)
            s = lax.while_loop(lambda t: cond(t) & (t.iters < hi), body, s)
            fresh = refactorize(A, b, s)
            return tree_select(s.status == st.RUNNING, fresh, s)

        return lax.while_loop(outer_cond, outer_body, state)

    return lax.while_loop(cond, body, state)


@partial(jax.jit, static_argnames=("cfg", "mode"))
def run_jit(c, A, b, state, allowed, maxiters, cfg: SolverConfig, mode: str):
    return run(c, A, b, state, allowed, maxiters, cfg, mode)


@partial(jax.jit, static_argnames=("cfg",))
def pivot_jit(A, b, state, leave, enter, cfg: SolverConfig):
    """Single explicit pivot (the reference's public ``pivot`` method)."""
    return apply_pivot(A, b, state, leave, enter, cfg)
