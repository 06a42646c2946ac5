"""Explicitly-batched simplex engine (the batched hot path).

The single-instance engine in :mod:`linprog_tpu.engine` is written per-lane
and lifted with ``vmap``.  That is correct and convenient, but the hot ops
then lower to whatever fusions XLA picks.  This module is the
performance-tuned twin: the step works on explicitly batched arrays
(``[B, ...]``) so pricing, the ratio test and the eta update are batched
einsums that XLA maps onto cuBLAS-class GEMV/GEMM calls.

Semantics are identical to ``vmap``-ing the per-lane engine: lanes whose
status is terminal freeze (their updates are masked), the loop runs until
every lane is terminal or at ``maxiters``.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax

from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .engine import SimplexState


def batched_in_basis_penalty(basis, n: int, allowed):
    """f32 ``[B, n]`` penalty: +inf on basis columns and disallowed columns."""
    B = basis.shape[0]
    inf = jnp.float32(jnp.inf)
    pen = jnp.zeros((B, n), jnp.float32).at[
        jnp.arange(B)[:, None], basis
    ].set(inf)
    return jnp.where(allowed[None, :], pen, inf)


def _gather_cols(A, idx):
    """``A[b, :, idx[b]]`` for each lane: [B, m]."""
    return jnp.take_along_axis(A, idx[:, None, None], axis=2)[:, :, 0]


def batched_primal_step(c, A, b, allowed, state: SimplexState, cfg: SolverConfig,
                        maxiters, bland=None, gamma=None):
    """One batched primal iteration over all lanes (finished lanes frozen).

    ``bland`` (optional bool[B]): lanes flagged True use Bland's
    first-eligible entering rule regardless of ``cfg.pricing`` -- the
    per-lane stall escalation of :func:`run_batched`.

    ``gamma`` (optional f32[B, n]): devex reference weights.  When
    ``cfg.pricing == "devex"`` it MUST be supplied (:func:`run_batched`
    threads it through its loop carry) and the return value becomes
    ``(state, gamma_updated)``: entering maximizes ``r^2 / gamma``, weights
    update from the pivot row, and the leaving variable re-enters the
    nonbasic pool at ``max(gamma_q / alpha_q^2, 1)``.
    """
    B, m, n = A.shape
    running = (state.status == st.RUNNING) & (state.iters < maxiters)

    cB = jnp.take_along_axis(c, state.basis, axis=1)
    penalty = batched_in_basis_penalty(state.basis, n, allowed)

    if cfg.pricing == "devex" and gamma is None:
        raise ValueError(
            "pricing='devex' on the batched step needs the devex weights "
            "(run_batched threads them through its loop carry)"
        )
    y = jnp.einsum("bm,bmk->bk", cB, state.inv_B)
    r = c - jnp.einsum("bm,bmn->bn", y, A) + penalty
    # per-lane scaled optimality tolerance (reference np.isclose rtol
    # semantics on badly scaled costs; see engine.primal_step)
    tol = (cfg.opt_tol * jnp.maximum(1.0, jnp.max(jnp.abs(c), axis=1)))[
        :, None
    ]
    if cfg.pricing == "devex":
        # reference-weight devex: maximize r^2 / gamma over eligible
        neg = r < -tol
        score = jnp.where(neg, (r * r) / gamma, -jnp.inf)
        enter = jnp.argmax(score, axis=1)
        eligible = jnp.take_along_axis(neg, enter[:, None], axis=1)[:, 0]
        if bland is not None:  # stalled lanes: first eligible column
            enter_b = jnp.argmax(neg, axis=1)
            enter = jnp.where(bland, enter_b, enter)
    elif cfg.pricing == "dantzig":
        enter = jnp.argmin(r, axis=1)
        eligible = (
            jnp.take_along_axis(r, enter[:, None], axis=1) < -tol
        )[:, 0]
        if bland is not None:  # stalled lanes: first eligible column
            enter_b = jnp.argmax(r < -tol, axis=1)
            enter = jnp.where(bland, enter_b, enter)
    else:
        neg = r < -tol
        enter = jnp.argmax(neg, axis=1)
        eligible = jnp.take_along_axis(neg, enter[:, None], axis=1)[:, 0]
    acol = _gather_cols(A, enter)
    d = jnp.einsum("bmk,bk->bm", state.inv_B, acol)
    pos = d > cfg.pivot_tol
    any_pos = jnp.any(pos, axis=1)
    # clamp refactorization noise (see engine.primal_step)
    bfs_nn = jnp.maximum(state.bfs, 0.0)
    theta = jnp.where(pos, bfs_nn / jnp.where(pos, d, 1.0), jnp.inf)
    leave = jnp.argmin(theta, axis=1)
    go = running & eligible & any_pos
    d_l = jnp.take_along_axis(d, leave[:, None], axis=1)[:, 0]
    safe = jnp.where(d_l == 0, 1.0, d_l)
    u = -d / safe[:, None]
    u = u.at[jnp.arange(B), leave].set(1.0 / safe - 1.0)
    u = jnp.where(go[:, None], u, 0.0)
    row = jnp.take_along_axis(state.inv_B, leave[:, None, None], axis=1)
    inv_B = state.inv_B + u[:, :, None] * row
    bfs_l = jnp.take_along_axis(state.bfs, leave[:, None], axis=1)
    bfs = state.bfs + u * bfs_l[:, 0][:, None]
    unbounded = eligible & ~any_pos
    if cfg.pricing == "devex":
        # alpha = pivot row of the OLD tableau (one extra O(mn) row
        # GEMV), gamma_j <- max(gamma_j, (alpha_j/alpha_q)^2 gamma_q); the
        # leaving variable re-enters the nonbasic pool at
        # max(gamma_q / alpha_q^2, 1)
        w = jnp.einsum("bm,bmn->bn", row[:, 0, :], A)
        ratio2 = (w / safe[:, None]) ** 2
        gamma_q = jnp.maximum(
            jnp.take_along_axis(gamma, enter[:, None], axis=1)[:, 0], 1.0
        )
        gamma_new = jnp.maximum(gamma, ratio2 * gamma_q[:, None])
        leaving_col = jnp.take_along_axis(
            state.basis, leave[:, None], axis=1
        )[:, 0]
        g_leave = jnp.maximum(gamma_q / (safe * safe), 1.0)
        gamma_new = gamma_new.at[jnp.arange(B), leaving_col].set(g_leave)
        gamma_new = jnp.minimum(gamma_new, 1e12)
        gamma = jnp.where(go[:, None], gamma_new, gamma)

    basis = jnp.where(
        go[:, None],
        state.basis.at[jnp.arange(B), leave].set(enter.astype(jnp.int32)),
        state.basis,
    )
    new_status = jnp.where(
        running & ~eligible,
        st.OPTIMAL,
        jnp.where(running & unbounded, st.PRIMAL_UNBOUNDED, state.status),
    ).astype(jnp.int32)
    iters = state.iters + running.astype(jnp.int32)
    out = SimplexState(
        basis=basis, inv_B=inv_B, bfs=bfs, iters=iters, status=new_status
    )
    return (out, gamma) if gamma is not None else out


def batched_refactorize(A, b, state: SimplexState) -> SimplexState:
    inv_B = jnp.linalg.inv(
        jnp.take_along_axis(A, state.basis[:, None, :], axis=2)
    )
    bfs = jnp.einsum("bmk,bk->bm", inv_B, b)
    return state._replace(inv_B=inv_B, bfs=bfs)


def compact_refactorize(A, b, basis, run):
    """Exact refactorization computed only for the still-running lanes.

    ``b`` is the per-lane rhs the fresh bfs is solved against (plain
    engine: the problem rhs; bounded engine: ``b - A x_N``).

    The between-segment batched inversion runs over ALL ``B`` lanes even
    when only a handful are still active, so most of it re-inverts lanes
    that already terminated (the lane-iteration distribution has a long
    tail, so late segments have few runners).  This sorts running
    lanes to the front (stable, so per-lane results are reproducible) and
    inverts only the smallest power-of-two prefix that covers them via
    ``lax.switch``; everyone else gets zeros, which callers mask out with
    their existing ``run``-gating.  Per running lane the result is
    BIT-EXACT identical to the full-batch inversion (batched LU is
    lane-independent), so pivot paths are unchanged.

    Returns ``(inv_full, bfs_full)`` with garbage (zeros) on lanes outside
    the computed prefix -- callers must already mask non-running lanes.
    """
    B, m, _ = A.shape
    sizes = [B >> i for i in range(6) if (B >> i) >= 8 and B % (1 << i) == 0]

    def full(operands):
        A_, b_, basis_, _ = operands
        inv = jnp.linalg.inv(
            jnp.take_along_axis(A_, basis_[:, None, :], axis=2)
        )
        bfs = jnp.einsum("bmk,bk->bm", inv, b_)
        return inv, bfs

    if len(sizes) <= 1:
        return full((A, b, basis, None))

    order = jnp.argsort(jnp.logical_not(run), stable=True)  # runners first
    K = jnp.sum(run.astype(jnp.int32))

    def make_branch(P):
        def br(operands):
            A_, b_, basis_, order_ = operands
            sel = order_[:P]
            invp = jnp.linalg.inv(
                jnp.take_along_axis(
                    jnp.take(A_, sel, axis=0),
                    jnp.take(basis_, sel, axis=0)[:, None, :], axis=2,
                )
            )
            bfsp = jnp.einsum("bmk,bk->bm", invp, jnp.take(b_, sel, axis=0))
            inv = jnp.zeros((B, m, m), A_.dtype).at[sel].set(invp)
            bfs = jnp.zeros((B, m), A_.dtype).at[sel].set(bfsp)
            return inv, bfs

        return br

    branches = [full] + [make_branch(P) for P in sizes[1:]]
    # branch i covers K <= sizes[i]; pick the smallest covering prefix
    idx = sum((K <= s).astype(jnp.int32) for s in sizes[1:])
    return lax.switch(idx, branches, (A, b, basis, order))


def _finite_lanes(inv_B, bfs):
    """bool[B]: lanes whose refreshed factors are all finite.

    A numerically singular basis (e.g. after a too-small pivot element)
    inverts to inf/NaN; without this guard the NaNs poison pricing and the
    lane silently reads as OPTIMAL.  Such lanes are frozen as
    NUMERICAL_ERROR instead (failure-detection surface, SURVEY section 5).
    """
    return jnp.all(jnp.isfinite(inv_B), axis=(1, 2)) & jnp.all(
        jnp.isfinite(bfs), axis=1
    )


def run_batched(c, A, b, state: SimplexState, allowed, maxiters,
                cfg: SolverConfig = DEFAULT_CONFIG,
                mode: str = "primal") -> SimplexState:
    """Drive the batched step (primal or dual) to termination.

    Primal mode runs the explicitly batched step below; dual mode runs the
    vmapped per-lane engine.
    """
    if mode == "dual":
        from . import engine

        return jax.vmap(
            engine.run, in_axes=(0, 0, 0, 0, None, None, None, None)
        )(c, A, b, state, allowed, maxiters, cfg, "dual")
    maxiters = jnp.asarray(maxiters, jnp.int32)
    B, _, n_cols = A.shape
    track = cfg.stall_limit > 0 and cfg.pricing in ("dantzig", "devex")
    use_devex = cfg.pricing == "devex"
    aux0 = (
        jnp.full((B,), jnp.inf, jnp.float32),  # z_prev
        jnp.zeros((B,), jnp.int32),  # stall counter
        jnp.zeros((B,), jnp.bool_),  # bland escalation flag
    )
    if use_devex:  # devex reference weights ride the loop carry
        aux0 = aux0 + (jnp.ones((B, n_cols), jnp.float32),)

    def any_running(carry):
        ss = carry[0]
        return jnp.any((ss.status == st.RUNNING) & (ss.iters < maxiters))

    def step(carry, hi):
        ss, z_prev, stall, bland = carry[:4]
        gamma = carry[4] if use_devex else None
        if track:
            # per-lane stall detection: no relative objective progress over
            # `stall_limit` pivots -> that lane's pricing escalates to
            # Bland's cycle-free rule until progress resumes.
            cB = jnp.take_along_axis(c, ss.basis, axis=1)
            z = jnp.einsum("bm,bm->b", cB, ss.bfs)
            progressed = jnp.abs(z - z_prev) > 1e-6 * (jnp.abs(z) + 1.0)
            stall = jnp.where(progressed, 0, stall + 1)
            bland = jnp.where(
                progressed, False, bland | (stall >= cfg.stall_limit)
            )
            z_prev = z
        out = batched_primal_step(
            c, A, b, allowed, ss, cfg, hi,
            bland=bland if track else None, gamma=gamma,
        )
        if use_devex:
            ss, gamma = out
            return (ss, z_prev, stall, bland, gamma)
        return (out, z_prev, stall, bland)

    if cfg.refactor_every > 0 and cfg.update == "eta":
        chunk = jnp.asarray(cfg.refactor_every, jnp.int32)

        def outer_body(carry):
            ss = carry[0]
            hi = jnp.minimum(jnp.min(jnp.where(
                ss.status == st.RUNNING, ss.iters, maxiters)) + chunk, maxiters)

            def inner_cond(cc):
                tt = cc[0]
                return jnp.any(
                    (tt.status == st.RUNNING) & (tt.iters < hi)
                )

            carry = lax.while_loop(
                inner_cond, lambda cc: step(cc, hi), carry
            )
            ss = carry[0]
            run = ss.status == st.RUNNING
            if cfg.compact_refactor:
                inv_c, bfs_c = compact_refactorize(A, b, ss.basis, run)
                fresh = ss._replace(inv_B=inv_c, bfs=bfs_c)
            else:
                fresh = batched_refactorize(A, b, ss)
            ok = _finite_lanes(fresh.inv_B, fresh.bfs)
            status = jnp.where(
                run & ~ok, st.NUMERICAL_ERROR, ss.status
            ).astype(jnp.int32)
            take = (run & ok)[:, None]
            inv_B = jnp.where(take[..., None], fresh.inv_B, ss.inv_B)
            bfs = jnp.where(take, fresh.bfs, ss.bfs)
            aux = carry[1:]
            if use_devex:  # weights reset to the fresh reference framework
                aux = aux[:-1] + (jnp.ones_like(aux[-1]),)
            return (
                ss._replace(inv_B=inv_B, bfs=bfs, status=status),
            ) + aux

        return lax.while_loop(any_running, outer_body, (state,) + aux0)[0]
    return lax.while_loop(
        any_running, lambda cc: step(cc, maxiters), (state,) + aux0
    )[0]
