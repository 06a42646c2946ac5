"""Sensitivity analysis (cost / RHS ranging) at an optimal basis.

A capability every production LP system exposes and the reference
(agmuth/linear-programming) lacks entirely: given the terminal state of a
standard-form solve ``min c'x s.t. Ax = b, x >= 0``, report for every cost
coefficient and every rhs entry the interval over which it can move while
the CURRENT OPTIMAL BASIS stays optimal (the solution point and duals then
change linearly; outside the interval the basis itself changes).

Everything is a few dense contractions on state the engine already carries
(``inv_B``, ``bfs``, reduced costs), so the batched versions are plain
``vmap``, no host round trips.

Math (textbook, e.g. Bertsimas & Tsitsiklis ch. 5):

* nonbasic cost ``c_j``: reduced cost ``r_j >= 0`` must stay nonnegative,
  so ``delta in [-r_j, +inf)``.
* basic cost ``c_{B(i)}``: reduced costs of nonbasics change by
  ``-delta * W[i, j]`` with ``W = inv_B A`` the tableau rows; keeping all
  ``r_j - delta W[i, j] >= 0`` bounds delta by ratios over the sign of
  ``W[i, j]``.
* rhs ``b_i``: basics move along column i of ``inv_B``; keeping
  ``x_B + delta inv_B[:, i] >= 0`` bounds delta by ratios over the sign
  of ``inv_B[k, i]``.

Degeneracy caveat: at a degenerate/dual-degenerate vertex the optimal
basis is not unique and the reported intervals are those of THIS basis
(the standard convention; they may be conservative).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .engine import SimplexState, reduced_costs


class RangingResult(NamedTuple):
    """Allowable increase/decrease intervals, absolute coefficient values.

    ``cost_lo/cost_hi [n]``: ``c_j`` may move within ``[cost_lo_j,
    cost_hi_j]`` (current value inside) without changing the optimal
    basis.  ``rhs_lo/rhs_hi [m]``: same for ``b_i`` (feasibility of the
    current basis).
    """

    cost_lo: jax.Array
    cost_hi: jax.Array
    rhs_lo: jax.Array
    rhs_hi: jax.Array


def ranging(c, A, b, state: SimplexState,
            nonneg_tol: float = 0.0) -> RangingResult:
    """Cost + RHS ranging at the (optimal) ``state`` of one instance."""
    m, n = A.shape
    inf = jnp.asarray(jnp.inf, A.dtype)
    r = reduced_costs(c, A, state)  # basis entries exactly 0

    in_basis = jnp.zeros((n,), bool).at[state.basis].set(True)

    # ---- nonbasic costs: delta in [-r_j, inf) -------------------------
    cost_lo = jnp.where(in_basis, -inf, c - jnp.maximum(r, 0.0))
    cost_hi = jnp.where(in_basis, inf, jnp.full((n,), inf, A.dtype))

    # ---- basic costs: ratios over tableau rows W = inv_B A ------------
    W = state.inv_B @ A  # [m, n]
    Wn = jnp.where(in_basis[None, :], 0.0, W)  # nonbasic columns only
    rn = jnp.where(in_basis, inf, jnp.maximum(r, nonneg_tol))
    pos = Wn > 1e-9
    neg = Wn < -1e-9
    # delta <= min over {j : W[i,j] > 0} of r_j / W[i,j]
    up = jnp.min(jnp.where(pos, rn[None, :] / jnp.where(pos, Wn, 1.0), inf),
                 axis=1)
    # delta >= max over {j : W[i,j] < 0} of r_j / W[i,j]
    dn = jnp.max(
        jnp.where(neg, rn[None, :] / jnp.where(neg, Wn, 1.0), -inf), axis=1
    )
    cB = jnp.take(c, state.basis)
    cost_lo = cost_lo.at[state.basis].set(cB + dn)
    cost_hi = cost_hi.at[state.basis].set(cB + up)

    # ---- rhs: ratios over inv_B columns -------------------------------
    xB = jnp.maximum(state.bfs, 0.0)[:, None]  # [m, 1]
    col = state.inv_B  # inv_B[k, i] = effect of b_i on x_{B(k)}
    posb = col > 1e-9
    negb = col < -1e-9
    # x_B + delta * inv_B[:, i] >= 0
    up_b = jnp.min(
        jnp.where(negb, xB / jnp.where(negb, -col, 1.0), inf), axis=0
    )
    dn_b = jnp.max(
        jnp.where(posb, -xB / jnp.where(posb, col, 1.0), -inf), axis=0
    )
    return RangingResult(
        cost_lo=cost_lo, cost_hi=cost_hi, rhs_lo=b + dn_b, rhs_hi=b + up_b
    )


def ranging_batch(c, A, b, states: SimplexState) -> RangingResult:
    """Batched ranging: ``c[B, n], A[B, m, n], b[B, m]`` + batched state."""
    return jax.vmap(ranging)(c, A, b, states)
