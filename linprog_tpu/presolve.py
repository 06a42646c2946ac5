"""Presolve: Ruiz equilibration scaling (batched, device-side).

The reference has no presolve at all.  Scaling matters doubly in f32:
float32 pricing error scales with the dynamic range of ``A``, and simplex
iteration counts grow on badly scaled instances.  Ruiz iteration:

    repeat k times:
        r_i <- 1 / sqrt(max_j |A_ij|)        (row scales)
        s_j <- 1 / sqrt(max_i |A_ij|)        (col scales)
        A <- diag(r) A diag(s)

converging to a matrix with all row/col inf-norms ~1.  The scaled problem
``min (S c)' z  s.t. (R A S) z = R b, z >= 0`` maps back by ``x = S z``
(positive scales keep ``z >= 0`` equivalent) and duals ``y = R y_scaled``.

All ops are elementwise + reductions: jit/vmap/shard-friendly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Scaling(NamedTuple):
    row: jax.Array  # [.., m] row scales R
    col: jax.Array  # [.., n] column scales S


def ruiz_equilibrate(c, A, b, iters: int = 6):
    """Equilibrate one instance (or a batch via leading dims).

    Returns ``(c_s, A_s, b_s, Scaling)``.
    """
    c = jnp.asarray(c)
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    m, n = A.shape[-2], A.shape[-1]
    row = jnp.ones(A.shape[:-1], A.dtype)  # [.., m]
    col = jnp.ones(A.shape[:-2] + (n,), A.dtype)  # [.., n]

    def body(_, carry):
        A_s, row, col = carry
        r = 1.0 / jnp.sqrt(
            jnp.maximum(jnp.max(jnp.abs(A_s), axis=-1), 1e-12)
        )
        A_s = A_s * r[..., :, None]
        s = 1.0 / jnp.sqrt(
            jnp.maximum(jnp.max(jnp.abs(A_s), axis=-2), 1e-12)
        )
        A_s = A_s * s[..., None, :]
        return A_s, row * r, col * s

    A_s, row, col = jax.lax.fori_loop(0, iters, body, (A, row, col))
    c_s = c * col
    b_s = b * row
    return c_s, A_s, b_s, Scaling(row=row, col=col)


def unscale_solution(x, scaling: Scaling):
    """Primal solution of the original problem: ``x = S z``."""
    return x * scaling.col


def unscale_duals(y, scaling: Scaling):
    """Dual variables of the original problem: ``y = R y_scaled``."""
    return y * scaling.row
