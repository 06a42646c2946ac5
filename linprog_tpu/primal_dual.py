"""Primal-dual algorithm (Papadimitriou & Steiglitz restricted-primal loop).

JAX rebuild of the reference ``PrimalDualAlgorithm``
(reference ``linprog/special_solvers.py:346-480``):

* start from the dual-feasible ``y = 0``; if ``min(c) < 0``, expand the
  problem with one bounding row ``sum(x) <= n*M`` so ``y = (0,..,min c)`` is
  dual feasible (reference ``special_solvers.py:385-400``, P&S pg. 105);
* loop: admissible set ``J = {j : y'A_j ~= c_j}``; solve the restricted
  primal; if its cost is positive, step the duals by ``theta`` along the
  restricted-dual direction; else complementary slackness holds -> optimal.

Key design change: the reference materializes the restricted
primal ``[A_J | I]`` by *fancy-indexing the admissible columns* -- a dynamic
shape per outer iteration.  Here the restricted primal is always the
full-width ``[A | I]`` with an ``allowed`` column mask handed to the engine's
pricing, so every inner solve reuses ONE compiled kernel.  Because
compaction preserves column order, Bland's rule visits the same admissible
columns in the same order, so the pivot sequence matches the reference's.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from functools import partial

import jax

from . import engine, forms
from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .results import LinProgResult
from .utils import get_bounds_on_bfs


def _device_primal_dual(c, A, b, M, maxiters1, maxiters2, cfg: SolverConfig):
    """Fully on-device primal-dual loop for ONE standard-form instance.

    Shape-static version of the restricted-primal iteration: the bounding
    row ``sum(x) <= n*M`` is ALWAYS added (harmless when ``min(c) >= 0``
    because Lemma 2.1 bounds every BFS coordinate below ``M``), so the
    computation jits once and vmaps over batches.  The inner simplex is the
    engine's while_loop nested inside the outer ``lax.while_loop``.
    """
    import jax
    from jax import lax

    m0, n0 = A.shape
    dt = A.dtype
    # unconditional expansion: one bounding row + one slack-ish variable
    A_x = jnp.concatenate([A, jnp.zeros((m0, 1), dt)], axis=1)
    A_x = jnp.concatenate([A_x, jnp.ones((1, n0 + 1), dt)], axis=0)
    b_x = jnp.concatenate([b, jnp.reshape(n0 * M, (1,))])
    c_x = jnp.concatenate([c, jnp.zeros((1,), dt)])
    m, n = m0 + 1, n0 + 1

    y0 = jnp.concatenate(
        [jnp.zeros((m0,), dt), jnp.reshape(jnp.minimum(jnp.min(c), 0.0), (1,))]
    )
    A_rp = jnp.concatenate([A_x, jnp.eye(m, dtype=dt)], axis=1)
    c_rp = jnp.concatenate([jnp.zeros((n,), dt), jnp.ones((m,), dt)])
    art_allowed = jnp.ones((m,), bool)
    cost_tol = cfg.feas_tol * jnp.maximum(1.0, jnp.max(jnp.abs(b_x))) * m

    # admissibility tolerance derived from cfg (was hardcoded 1e-7 + 1e-5|c|
    # -- the one place the config discipline slipped): with the default
    # opt_tol = 1e-6 these resolve to the same atol/rtol pair the reference's
    # np.isclose uses at special_solvers.py:405 (atol 1e-8-ish, rtol 1e-5)
    adm_atol = 0.1 * cfg.opt_tol
    adm_rtol = 10.0 * cfg.opt_tol

    def inner(y):
        admissible = (
            jnp.abs(y @ A_x - c_x) <= adm_atol + adm_rtol * jnp.abs(c_x)
        )
        allowed = jnp.concatenate([admissible, art_allowed])
        state = engine.artificial_state(b_x, n)
        state = engine.run(
            c_rp, A_rp, b_x, state, allowed, maxiters2, cfg, "primal"
        )
        return state, admissible

    def cond(carry):
        y, counter, status, _, _ = carry
        return (status == st.RUNNING) & (counter < maxiters1)

    def body(carry):
        y, counter, status, _, _ = carry
        state, admissible = inner(y)
        rp_cost = engine.current_cost(c_rp, state)
        y_r = engine.duals(c_rp, state)
        feasible = rp_cost <= cost_tol
        dual_unb = jnp.all(y_r @ A_rp <= cfg.feas_tol)
        num = c_x - y @ A_x
        den = y_r @ A_x
        ratios = jnp.where(
            (den > cfg.pivot_tol) & jnp.logical_not(admissible),
            num / jnp.where(den > cfg.pivot_tol, den, 1.0),
            jnp.inf,
        )
        theta = jnp.min(ratios)
        no_step = jnp.logical_not(jnp.isfinite(theta))
        new_status = jnp.where(
            feasible,
            st.OPTIMAL,
            jnp.where(dual_unb | no_step, st.DUAL_UNBOUNDED, st.RUNNING),
        ).astype(jnp.int32)
        y_new = jnp.where(
            feasible | dual_unb | no_step, y, y + theta * y_r
        )
        return y_new, counter + 1, new_status, state.basis, state.bfs

    # abstract-eval only (the inner solver is a full nested while-loop;
    # tracing it twice just for carry shapes doubled trace time)
    shape_state, _ = jax.eval_shape(inner, y0)
    carry = (
        y0,
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros(shape_state.basis.shape, shape_state.basis.dtype),
        jnp.zeros(shape_state.bfs.shape, shape_state.bfs.dtype),
    )
    y, counter, status, basis, bfs = lax.while_loop(cond, body, carry)
    status = jnp.where(status == st.RUNNING, st.ITER_LIMIT, status)

    structural = basis < n
    x_full = jnp.zeros((n,), dt).at[
        jnp.where(structural, basis, n - 1)
    ].add(jnp.where(structural, bfs, 0.0))
    x = x_full[:n0]  # strip the bounding variable
    cost = c @ x
    return x, cost, counter, status.astype(jnp.int32), y[:m0]


@partial(jax.jit, static_argnames=("maxiters1", "maxiters2", "cfg"))
def solve_primal_dual_batch(
    c, A, b,
    maxiters1: int = 100,
    maxiters2: int = 100,
    cfg: SolverConfig = DEFAULT_CONFIG,
):
    """Batched, fully on-device primal-dual solve.

    ``c[B, n], A[B, m, n], b[B, m]`` standard form with ``b >= 0``.
    Returns ``(x[B, n], cost[B], iters[B], status[B], y[B, m])`` -- the
    whole restricted-primal loop (inner simplex included) runs inside one
    compiled computation per batch, with no host round-trips; something the
    reference's nested host loops (``special_solvers.py:370-480``) cannot
    express at all.
    """
    import jax

    M = jax.vmap(get_bounds_on_bfs)(A, b)
    return jax.vmap(
        _device_primal_dual, in_axes=(0, 0, 0, 0, None, None, None)
    )(c, A, b, M, maxiters1, maxiters2, cfg)


class PrimalDualAlgorithm:
    """Primal-dual LP algorithm (no starting basis required)."""

    def __init__(self, c, A, b, config: Optional[SolverConfig] = None):
        self.config = config or DEFAULT_CONFIG
        dtype = np.dtype(self.config.dtype)
        self.c, self.A, self.b = forms.preprocess_problem(c, A, b, dtype)
        self.m, self.n = self.A.shape
        self.counter = 0
        self.optimum = False

    def solve(self, maxiters1: int = 100, maxiters2: int = 100) -> LinProgResult:
        cfg = self.config
        dtype = np.dtype(cfg.dtype)
        c, A, b = self.c.copy(), self.A.copy(), self.b.copy()
        m, n = A.shape

        # dual-feasible start: y = 0 needs c >= 0; otherwise append the
        # bounding row sum(x) <= n*M (one extra var + row) and start from
        # y = (0, ..., 0, min c).
        y = np.zeros(m, dtype=dtype)
        expanded = False
        if c.min() < 0:
            expanded = True
            M = float(get_bounds_on_bfs(A, b))
            c = np.concatenate([c, np.zeros(1, dtype=dtype)])
            A = np.block(
                [
                    [A, np.zeros((m, 1), dtype=dtype)],
                    [np.ones((1, n + 1), dtype=dtype)],
                ]
            )
            b = np.concatenate([b, np.array([n * M], dtype=dtype)])
            m, n = A.shape
            y = np.concatenate([y, np.full(1, c.min(), dtype=dtype)])

        # static full-width restricted primal: [A | I] with artificial cost
        A_rp = jnp.asarray(np.concatenate([A, np.eye(m, dtype=dtype)], axis=1))
        c_rp = jnp.concatenate(
            [jnp.zeros(n, dtype=dtype), jnp.ones(m, dtype=dtype)]
        )
        b_dev = jnp.asarray(b)
        c_dev = jnp.asarray(c)
        A_dev = jnp.asarray(A)
        art_allowed = jnp.ones(m, dtype=bool)

        scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
        cost_tol = cfg.feas_tol * scale * max(1, m)

        self.counter = 0
        self.optimum = False
        state = None
        admissible = None
        while self.counter < maxiters1:
            self.counter += 1
            # admissible columns: y'A_j ~= c_j (reference uses np.isclose)
            ya = y @ A
            admissible = np.isclose(ya, c, rtol=1e-5, atol=1e-7)
            allowed = jnp.concatenate([jnp.asarray(admissible), art_allowed])

            state = engine.artificial_state(b_dev, n)
            state = engine.run_jit(
                c_rp, A_rp, b_dev, state, allowed,
                jnp.asarray(maxiters2, jnp.int32), cfg, "primal",
            )
            rp_cost = float(engine.current_cost(c_rp, state))

            if rp_cost > cost_tol:
                # restricted dual direction y_r = c_B @ inv_B
                y_r = np.asarray(engine.duals(c_rp, state))
                if np.all(y_r @ np.asarray(A_rp) <= cfg.feas_tol):
                    raise st.DualIsUnboundedError(
                        "restricted dual is unbounded: primal is infeasible"
                    )
                num = c - y @ A
                den = y_r @ A
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratios = np.where(den > cfg.pivot_tol, num / den, np.inf)
                theta = float(np.min(ratios[~admissible]))
                if not np.isfinite(theta):
                    raise st.DualIsUnboundedError(
                        "no admissible dual step: primal is infeasible"
                    )
                y = y + theta * y_r
            else:
                self.optimum = True
                break

        # reconstruct x in the original space: basis entries < n are
        # structural columns of A directly (no compaction bookkeeping).
        basis = np.asarray(state.basis)
        bfs = np.asarray(state.bfs)
        x = np.zeros(n, dtype=dtype)
        structural = basis < n
        x[basis[structural]] = bfs[structural]
        out_basis = np.sort(basis[structural])

        if expanded:
            out_basis = out_basis[out_basis != n - 1]
            x = x[:-1]

        cost = float(self.c @ x)
        return LinProgResult(
            x=x,
            basis=out_basis,
            cost=cost,
            iters=self.counter,
            optimum=self.optimum,
            status=st.OPTIMAL if self.optimum else st.ITER_LIMIT,
        )
