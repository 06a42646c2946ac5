"""Numeric kernel utilities.

JAX equivalents of the reference's ``linprog/utils.py``:

* The masked ratio-test divisions are single fused VPU ops (``jnp.where``)
  instead of ``np.vectorize`` over a scalar Python lambda
  (reference ``linprog/utils.py:5-17``).
* The Papadimitriou big-M bound is computed in log space so it cannot
  overflow: the reference's ``factorial(m) * alpha**(m-1) * beta``
  (reference ``linprog/utils.py:20-40``) overflows float64 already at m≈170
  and float32 at m≈10.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def primal_simplex_div(numer, denom, pivot_tol: float = 0.0):
    """Elementwise ``numer / denom`` where ``denom > pivot_tol``, else ``+inf``.

    The heart of the primal ratio test (reference ``linprog/utils.py:5-10``),
    as one branchless VPU op.
    """
    numer = jnp.asarray(numer)
    denom = jnp.asarray(denom)
    mask = denom > pivot_tol
    safe = jnp.where(mask, denom, jnp.ones_like(denom))
    return jnp.where(mask, numer / safe, jnp.inf)


def dual_simplex_div(numer, denom, pivot_tol: float = 0.0):
    """Elementwise ``-numer / denom`` where ``denom < -pivot_tol``, else ``+inf``.

    The dual ratio test primitive (reference ``linprog/utils.py:12-17``).
    """
    numer = jnp.asarray(numer)
    denom = jnp.asarray(denom)
    mask = denom < -pivot_tol
    safe = jnp.where(mask, denom, -jnp.ones_like(denom))
    return jnp.where(mask, -numer / safe, jnp.inf)


def get_bounds_on_bfs(A, b, cap: float | None = None):
    """Bound on ``|x_i|`` over all basic feasible solutions.

    Lemma 2.1 of Papadimitriou & Steiglitz: ``M = m! * alpha^(m-1) * beta``
    with ``alpha = max|A_ij|``, ``beta = max|b_i|``.  Computed as
    ``exp(lgamma(m+1) + (m-1) log alpha + log beta)`` and clamped to ``cap``
    so it stays finite and numerically usable at any ``m`` (the reference's
    direct ``factorial(m)`` overflows fast, ``linprog/utils.py:39``).

    For small ``m`` and modest data (every reference test case) the exact and
    log-space values agree to float precision, preserving parity.
    """
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    m = A.shape[0]
    if cap is None:
        cap = 1e30 if A.dtype == jnp.float64 else 1e7
    alpha = jnp.max(jnp.abs(A))
    beta = jnp.max(jnp.abs(b))
    # log-space to avoid overflow; guard zeros (alpha==0 or beta==0 => M=0
    # would make the bound vacuous; fall back to beta like the exact formula).
    log_alpha = jnp.log(jnp.maximum(alpha, jnp.finfo(A.dtype).tiny))
    log_beta = jnp.log(jnp.maximum(beta, jnp.finfo(A.dtype).tiny))
    log_m_fact = lax.lgamma(jnp.asarray(m + 1, dtype=jnp.float32))
    log_M = log_m_fact.astype(A.dtype) + (m - 1) * log_alpha + log_beta
    M = jnp.exp(jnp.minimum(log_M, jnp.log(jnp.asarray(cap, A.dtype))))
    return jnp.where(beta == 0, jnp.zeros_like(M), M)
