"""Phase I: find a basic feasible solution with artificial variables.

JAX rebuild of the reference ``PhaseOneSimplexSolver``
(reference ``linprog/special_solvers.py:11-91``):

* append ``m`` artificials (``A <- [A | I]``, ``c <- [0..0, 1..1]``) and run
  the primal engine from the all-artificial basis -- here the artificial
  start state is free (``inv_B = I``, ``bfs = b``; no inversion);
* positive optimal cost => primal infeasible; non-convergence => ValueError
  (reference ``special_solvers.py:55-59``);
* drive remaining zero-level artificials out of a degenerate basis wherever a
  nonzero pivot entry exists among nonbasic structural columns -- the
  reference does this in a Python loop of host pivots
  (``special_solvers.py:61-80``); here it is one jitted ``lax.scan`` over
  basis positions;
* rows whose artificial cannot be driven out are redundant and dropped
  (reference ``special_solvers.py:82-89``; note the reference's off-by-one
  ``res.basis <= self.n`` redundancy test -- this implementation uses the
  correct strict ``< n``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import engine
from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig


def phase1_problem(c, A, b):
    """Build the Phase-I problem ``([A | I], [0..0, 1..1])`` on device."""
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    m, n = A.shape
    A1 = jnp.concatenate([A, jnp.eye(m, dtype=A.dtype)], axis=1)
    c1 = jnp.concatenate([jnp.zeros(n, A.dtype), jnp.ones(m, A.dtype)])
    return c1, A1, b


@partial(jax.jit, static_argnames=("n_structural", "cfg"))
def drive_out_artificials(A1, b, state: engine.SimplexState, n_structural: int, cfg: SolverConfig):
    """Pivot zero-level artificials out of the basis where possible.

    One pass over basis positions as a ``lax.scan``; at each position holding
    an artificial, the entering column is the first nonbasic *structural*
    column with a positive entry in that row of ``inv_B @ A`` (the reference's
    selection, ``special_solvers.py:61-80``).  These pivots are degenerate
    (``bfs[pos] == 0``), so feasibility is preserved without a ratio test.
    """
    n_tot = A1.shape[1]
    col_ids = jnp.arange(n_tot)
    structural = col_ids < n_structural

    def body(s: engine.SimplexState, pos):
        is_art = s.basis[pos] >= n_structural
        row = s.inv_B[pos] @ A1
        nonbasic = ~engine.in_basis_mask(s.basis, n_tot)
        cand = (row > cfg.pivot_tol) & nonbasic & structural
        found = jnp.any(cand)
        enter = jnp.argmax(cand)
        pivoted = engine.apply_pivot(A1, b, s, pos, enter, cfg)
        s = engine.tree_select(is_art & found, pivoted, s)
        return s, None

    m = b.shape[0]
    state, _ = lax.scan(body, state, jnp.arange(m))
    return state


class Phase1Result(NamedTuple):
    basis: np.ndarray  # starting basis for Phase II (len == rows kept)
    A: np.ndarray  # possibly row-reduced constraint matrix
    b: np.ndarray  # possibly row-reduced rhs
    iters: int
    dropped_rows: np.ndarray  # indices of redundant rows removed


def solve_phase1(
    c,
    A,
    b,
    maxiters: int = 100,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> Phase1Result:
    """Run Phase I; return a Phase-II starting basis (host-orchestrated).

    Raises ``PrimalIsInfeasibleError`` if the optimal artificial cost is
    positive, ``ValueError`` if Phase I hits ``maxiters`` (parity with
    reference ``special_solvers.py:55-59``).
    """
    A = np.asarray(A)
    b = np.asarray(b)
    m, n = A.shape
    c1, A1, b_dev = phase1_problem(c, A, b)
    state = engine.artificial_state(b_dev, n)
    allowed = jnp.ones((n + m,), jnp.bool_)
    state = engine.run_jit(c1, A1, b_dev, state, allowed, maxiters, cfg, "primal")

    cost = float(engine.current_cost(c1, state))
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    if cost > cfg.feas_tol * scale * max(1, m):
        if int(state.status) == st.OPTIMAL:
            err = st.PrimalIsInfeasibleError(
                f"Phase I optimum {cost:.3e} > 0: no feasible point exists."
            )
            # Farkas certificate from the Phase-I duals: y'A <= 0 (the
            # structural reduced costs are nonnegative at optimality) and
            # y'b = artificial cost > 0 together prove infeasibility
            err.certificate = np.asarray(engine.duals(c1, state))
            raise err
        raise ValueError("Phase one did not converge.")

    state = drive_out_artificials(A1, b_dev, state, n, cfg)

    basis = np.asarray(state.basis)
    art_pos = basis >= n
    dropped = np.array([], dtype=int)
    if art_pos.any():
        # remaining artificials mark linearly dependent rows: drop the
        # artificial's own constraint row and its basis position.
        dropped = np.sort(basis[art_pos] - n)
        keep_rows = np.ones(m, dtype=bool)
        keep_rows[dropped] = False
        A = A[keep_rows]
        b = b[keep_rows]
        basis = basis[~art_pos]
    return Phase1Result(
        basis=basis.astype(np.int32),
        A=A,
        b=b,
        iters=int(state.iters),
        dropped_rows=dropped,
    )
