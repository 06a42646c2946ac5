"""Batched LP solving: thousands of independent instances per device.

This is the headline capability the reference (a strictly single-problem,
single-thread NumPy library -- SURVEY.md section 2.2) has no counterpart for:
the whole two-phase simplex pipeline runs inside ONE jitted computation,
``vmap``-ped over a batch of same-shape LP instances.  Per-lane termination
is handled by the engine's status codes (finished lanes freeze while the
batch keeps stepping), and optional periodic refactorization bounds
eta-update drift on long solves.

Design notes:

* all shapes static: one compiled kernel serves every batch of a given
  ``(B, m, n)``;
* Phase I keeps artificial columns in the matrix for Phase II and masks them
  out of pricing instead of re-allocating (no dynamic shapes, no host
  round-trips per pivot);
* redundant rows are left masked (their artificial stays basic at zero
  level) rather than dropped -- same optima, static shapes;
* refactorization happens *outside* the vmapped while_loop so the
  "recompute inv(B)" branch is a real scalar branch, not a per-lane select.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import engine
from . import status as st
from .config import DEFAULT_CONFIG, SolverConfig
from .results import BatchResult


def _run_chunked(c, A, b, states, allowed, maxiters, cfg: SolverConfig, mode: str):
    """Drive the batch to termination.

    The primal mode routes through the explicitly-batched engine (batched
    einsums, periodic refactorization); the dual mode uses the vmapped
    per-lane engine.
    """
    from .engine_batched import run_batched

    return run_batched(c, A, b, states, allowed, maxiters, cfg, mode)


@partial(jax.jit, static_argnames=("cfg", "mode"))
def solve_batch_from_basis(
    c, A, b, basis, maxiters, cfg: SolverConfig = DEFAULT_CONFIG, mode: str = "primal"
) -> BatchResult:
    """Solve a batch of standard-form LPs from given starting bases.

    ``c[B, n]``, ``A[B, m, n]``, ``b[B, m]``, ``basis[B, m]``.
    """
    n = c.shape[-1]
    states = jax.vmap(engine.make_state, in_axes=(0, 0, 0))(A, b, basis)
    allowed = jnp.ones((n,), jnp.bool_)
    states = _run_chunked(c, A, b, states, allowed, maxiters, cfg, mode)
    return _to_result(c, states, n)


@partial(jax.jit, static_argnames=("cfg", "maxiters1", "maxiters2"))
def solve_batch_two_phase(
    c,
    A,
    b,
    maxiters1: int = 1000,
    maxiters2: int = 1000,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> BatchResult:
    """Fully on-device two-phase solve of a batch of standard-form LPs.

    No starting basis needed; no host round-trips anywhere: Phase I
    (artificial variables), the feasibility verdict, and Phase II all happen
    inside one compiled computation.  ``c[B, n]``, ``A[B, m, n]``, ``b[B, m]``
    with ``b`` made nonnegative by :func:`linprog_tpu.forms.preprocess_problem`.
    """
    B, m, n = A.shape
    dt = A.dtype

    c_orig = c
    if cfg.scaling:
        from .presolve import ruiz_equilibrate

        c, A, b, scaling = ruiz_equilibrate(c, A, b)

    eye = jnp.broadcast_to(jnp.eye(m, dtype=dt), (B, m, m))
    A1 = jnp.concatenate([A, eye], axis=2)  # [B, m, n+m]
    c1 = jnp.broadcast_to(
        jnp.concatenate([jnp.zeros(n, dt), jnp.ones(m, dt)]), (B, n + m)
    )
    c2 = jnp.concatenate([c, jnp.zeros((B, m), dt)], axis=1)

    # ---- Phase I: slack crash basis, everything allowed to enter ---------
    # (unit columns serve as their row's basis entry; artificials only where
    # no unit column exists -- typically halves Phase-I pivots)
    states = jax.vmap(engine.slack_crash_state, in_axes=(0, 0, None))(A1, b, n)
    allowed1 = jnp.ones((n + m,), jnp.bool_)
    states = _run_chunked(c1, A1, b, states, allowed1, maxiters1, cfg, "primal")

    art_cost = jnp.sum(jnp.where(states.basis >= n, states.bfs, 0.0), axis=1)
    scale = jnp.maximum(1.0, jnp.max(jnp.abs(b), axis=1)) * m
    infeasible = (states.status == st.OPTIMAL) & (art_cost > cfg.feas_tol * scale)
    p1_stalled = states.status == st.RUNNING  # phase-I iteration cap
    phase1_iters = states.iters
    # Phase-I duals at an infeasible optimum ARE a Farkas certificate:
    # r_j = -y'A_j >= 0 for structural columns and y'b = artificial cost
    # > 0 prove no feasible x exists (same certificate surface the PDHG
    # family exposes).  Reported as `y` for PRIMAL_INFEASIBLE lanes.
    y_farkas = jax.vmap(engine.duals)(c1, states)

    # ---- Phase II: structural columns only; artificials stay masked ------
    new_status = jnp.where(
        infeasible,
        st.PRIMAL_INFEASIBLE,
        jnp.where(p1_stalled, st.ITER_LIMIT, st.RUNNING),
    ).astype(jnp.int32)
    states = states._replace(
        status=new_status, iters=jnp.zeros_like(states.iters)
    )
    allowed2 = jnp.arange(n + m) < n
    states = _run_chunked(c2, A1, b, states, allowed2, maxiters2, cfg, "primal")

    # final accuracy pass: the basis is discrete (and terminal), but the
    # reported x comes from the drifted eta-product bfs.  One exact solve of
    # B x_B = b at the final basis collapses the float32 objective gap by
    # ~1-2 orders of magnitude for ~0.2s per 1024x256 batch.
    B_final = jnp.take_along_axis(A1, states.basis[:, None, :], axis=2)
    bfs_exact = jnp.linalg.solve(B_final, b[:, :, None])[:, :, 0]
    ok = jnp.all(jnp.isfinite(bfs_exact), axis=1)
    states = states._replace(
        bfs=jnp.where(ok[:, None], bfs_exact, states.bfs),
        # a numerically singular terminal basis must not read as OPTIMAL
        status=jnp.where(
            ok, states.status, st.NUMERICAL_ERROR
        ).astype(jnp.int32),
    )

    if cfg.polish_pivots > 0:
        # double-word terminal polish: accurate repricing exposes the truly
        # negative reduced costs f32 pricing cannot see; a few dd-guided
        # cleanup pivots move each lane to the genuinely optimal vertex
        from .refine import polish_batch

        act = states.status == st.OPTIMAL
        pbasis, pxB, _, pinv, _ = polish_batch(
            c2, A1, b, states.basis, allowed2, act,
            max_pivots=cfg.polish_pivots, pivot_tol=cfg.pivot_tol,
            inv_B=states.inv_B,
        )
        states = states._replace(
            basis=jnp.where(act[:, None], pbasis, states.basis),
            bfs=jnp.where(act[:, None], pxB, states.bfs),
            inv_B=jnp.where(act[:, None, None], pinv, states.inv_B),
        )
        # exact + dd-refined solve AT THE POLISHED BASIS, plus a
        # duality-based objective correction.  Measured at m=1024: the
        # terminal basis is f64-verified OPTIMAL but XLA's f32 LU solve
        # carries ~5e-3 forward error (cond ~ 1e4) and even dd-refined
        # iterates stall at ~5e-5 (the dd residual's own ~1e-6 floor), so
        # the reported objective sat 2.6e-5 off HiGHS.  The identity
        # c_B dx = y' B dx = y' r turns the remaining x error into a
        # SECOND-ORDER objective error: cost += y'(b - B x_B) with both
        # factors ~1e-5 -> ~1e-10 residual objective error.
        from .refine import dd_dot, dd_residual

        B_pol = jnp.take_along_axis(A1, states.basis[:, None, :], axis=2)
        xB = jnp.linalg.solve(B_pol, b[:, :, None])[:, :, 0]
        r_dd = dd_residual(b, B_pol, xB)
        xB = xB + jnp.linalg.solve(B_pol, r_dd[:, :, None])[:, :, 0]
        good = act & jnp.all(jnp.isfinite(xB), axis=1)
        states = states._replace(
            bfs=jnp.where(good[:, None], xB, states.bfs)
        )
        cB_pol = jnp.take_along_axis(c2, states.basis, axis=1)
        y_pol = jnp.linalg.solve(
            jnp.swapaxes(B_pol, 1, 2), cB_pol[:, :, None]
        )[:, :, 0]
        r2 = dd_residual(b, B_pol, states.bfs)
        obj_corr = jnp.where(good, dd_dot(y_pol, r2), 0.0)
        obj_corr = jnp.where(jnp.isfinite(obj_corr), obj_corr, 0.0)
    else:
        obj_corr = 0.0

    res = _to_result(c2, states, n + m)
    # report x/cost in the structural space and the ORIGINAL scaling;
    # iters = Phase I + Phase II
    x = res.x[:, :n]
    y = jnp.where(infeasible[:, None], y_farkas, res.y)
    if cfg.scaling:
        from .presolve import unscale_duals, unscale_solution

        x = unscale_solution(x, scaling)
        y = unscale_duals(y, scaling)
    if cfg.polish_pivots > 0:  # compensated objective to match the polish
        from .refine import dd_dot

        # the objective scalar is invariant under the Ruiz scaling, so the
        # duality correction from the scaled system applies directly
        cost = dd_dot(c_orig, x) + obj_corr
    else:
        cost = jnp.sum(c_orig * x, axis=1)
    return BatchResult(
        x=x,
        basis=res.basis,
        cost=cost,
        iters=phase1_iters + res.iters,
        status=res.status,
        y=y,
    )


def _to_result(c, states: engine.SimplexState, n: int) -> BatchResult:
    x = jax.vmap(engine.expand_bfs, in_axes=(0, None))(states, n)
    status = jnp.where(
        states.status == st.RUNNING, st.ITER_LIMIT, states.status
    ).astype(jnp.int32)
    y = jax.vmap(engine.duals)(c, states)
    return BatchResult(
        x=x,
        basis=states.basis,
        cost=jnp.sum(c * x, axis=1),
        iters=states.iters,
        status=status,
        y=y,
    )


@partial(jax.jit, static_argnames=("cfg",))
def reoptimize_batch_new_rhs(
    c, A, b_new, basis, maxiters, cfg: SolverConfig = DEFAULT_CONFIG
) -> BatchResult:
    """Warm-started batched re-solve after the right-hand side changed.

    The classic dual-simplex workflow the reference's dual solvers exist
    for, batched: an optimal basis stays DUAL feasible when ``b`` changes,
    so re-optimization from it needs only a handful of dual pivots instead
    of a full two-phase solve.  ``c[B, n], A[B, m, n], b_new[B, m],
    basis[B, m]`` -- ``basis`` typically comes from a prior
    :func:`solve_batch_two_phase` on the same ``(c, A)`` (its entries must
    index structural columns, i.e. ``< n``).

    Lanes where the old basis is already primal feasible for ``b_new``
    terminate in one iteration; ``DUAL_UNBOUNDED`` status means the
    perturbed instance is primal infeasible.
    """
    n = c.shape[-1]
    states = jax.vmap(engine.make_state, in_axes=(0, 0, 0))(A, b_new, basis)
    allowed = jnp.ones((n,), jnp.bool_)
    states = _run_chunked(c, A, b_new, states, allowed, maxiters, cfg, "dual")

    # primal cleanup pass (standard dual-then-primal re-optimization): the
    # dual phase restores feasibility but its float32 pricing can stop one
    # or two pivots shy of optimal.  Refactor exactly, re-open OPTIMAL
    # lanes, and let the primal engine re-verify/finish -- a truly optimal
    # lane terminates in one in-kernel iteration.
    inv = jnp.linalg.inv(
        jnp.take_along_axis(A, states.basis[:, None, :], axis=2)
    )
    bfs = jnp.einsum("bmk,bk->bm", inv, b_new)
    reopen = states.status == st.OPTIMAL
    states = states._replace(
        inv_B=jnp.where(reopen[:, None, None], inv, states.inv_B),
        bfs=jnp.where(reopen[:, None], bfs, states.bfs),
        status=jnp.where(reopen, st.RUNNING, states.status).astype(jnp.int32),
    )
    states = _run_chunked(c, A, b_new, states, allowed, maxiters, cfg, "primal")

    # exact final solve at the terminal basis (same accuracy pass as the
    # two-phase pipeline)
    B_final = jnp.take_along_axis(A, states.basis[:, None, :], axis=2)
    bfs_exact = jnp.linalg.solve(B_final, b_new[:, :, None])[:, :, 0]
    states = states._replace(bfs=bfs_exact)

    if cfg.polish_pivots > 0:
        # dd-polish analogue for the dual re-optimization path: same
        # double-word terminal repricing + cleanup pivots the two-phase
        # pipeline applies (the dual+primal f32 passes share its ~5e-4
        # pricing accuracy floor)
        from .refine import dd_dot, polish_batch

        act = states.status == st.OPTIMAL
        pbasis, pxB, _, pinv, _ = polish_batch(
            c, A, b_new, states.basis, allowed, act,
            max_pivots=cfg.polish_pivots, pivot_tol=cfg.pivot_tol,
            inv_B=states.inv_B,
        )
        states = states._replace(
            basis=jnp.where(act[:, None], pbasis, states.basis),
            bfs=jnp.where(act[:, None], pxB, states.bfs),
            inv_B=jnp.where(act[:, None, None], pinv, states.inv_B),
        )
        res = _to_result(c, states, n)
        return res._replace(cost=dd_dot(c, res.x))
    return _to_result(c, states, n)


@partial(jax.jit, static_argnames=("cfg",))
def solve_batch_bounded(
    c, A, b, lb, ub, basis, var_state, maxiters,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> BatchResult:
    """Batched bounded-variable simplex: ``min c'x, Ax=b, lb<=x<=ub``.

    ``c[B,n], A[B,m,n], b[B,m], lb[B,n], ub[B,n], basis[B,m],
    var_state[B,n]`` (int8 in {AT_LB=0, AT_UB=1, BASIC=2}).  The batched
    counterpart of :class:`BoundedVariablePrimalSimplexSolver`; bounds must
    be finite (clamp with :func:`linprog_tpu.utils.get_bounds_on_bfs`).
    """
    from . import bounded as bnd
    from .refine import dd_dot, dd_residual, refine_bfs

    basis = jnp.asarray(basis, jnp.int32)
    var_state = jnp.asarray(var_state, jnp.int8)
    B = A.shape[0]

    def one(ci, Ai, bi, lbi, ubi, basisi, vsi):
        state = bnd.make_bounded_state(Ai, bi, lbi, ubi, basisi, vsi)
        return bnd.run_bounded(ci, Ai, bi, lbi, ubi, state, maxiters, cfg)

    out = jax.vmap(one)(c, A, b, lb, ub, basis, var_state)
    basis_out, var_out = out.basis, out.var_state
    iters, status = out.iters, out.status
    status = jnp.where(status == st.RUNNING, st.ITER_LIMIT, status)

    # terminal accuracy pass (same contract as solve_batch_two_phase): the
    # engine's bfs carries eta drift; re-solve B x_B = b - A x_N exactly at
    # the terminal basis, with the rhs itself computed double-word (the
    # f32 A @ x_N product alone costs ~1e-5 relative at m=256 bounds)
    def rhs_of(vs):
        x_n = jnp.where(
            vs == bnd.AT_LB, lb,
            jnp.where(
                (vs == bnd.AT_UB) & jnp.isfinite(ub), ub, jnp.zeros_like(lb)
            ),
        )
        return x_n, dd_residual(b, A, x_n)

    Bmat = jnp.take_along_axis(A, basis_out[:, None, :], axis=2)
    _, rhs = rhs_of(var_out)
    inv_B = jnp.linalg.inv(Bmat)
    xB = jnp.einsum("bmk,bk->bm", inv_B, rhs)
    ok = jnp.all(jnp.isfinite(inv_B), axis=(1, 2)) & jnp.all(
        jnp.isfinite(xB), axis=1
    )
    xB = jnp.where(ok[:, None], refine_bfs(Bmat, rhs, inv_B, xB), out.bfs)
    status = jnp.where(ok, status, st.NUMERICAL_ERROR).astype(jnp.int32)

    obj_corr = 0.0
    if cfg.polish_pivots > 0:
        # bound-aware dd polish (VERDICT r3 item 5): double-word repricing
        # with the at-ub sign flip + 3-way-ratio cleanup steps, then the
        # duality objective correction y'(rhs - B x_B)
        from .refine import polish_bounded_batch

        act = (status == st.OPTIMAL) & ok
        pbasis, pvs, pxB, py, pinv = polish_bounded_batch(
            c, A, b, lb, ub, basis_out, var_out, act,
            max_pivots=cfg.polish_pivots, pivot_tol=cfg.pivot_tol,
            inv_B=inv_B,
        )
        basis_out = jnp.where(act[:, None], pbasis, basis_out)
        var_out = jnp.where(act[:, None], pvs, var_out)
        xB = jnp.where(act[:, None], pxB, xB)
        Bmat = jnp.take_along_axis(A, basis_out[:, None, :], axis=2)
        _, rhs = rhs_of(var_out)
        r2 = dd_residual(rhs, Bmat, xB)
        corr = dd_dot(py, r2)
        obj_corr = jnp.where(act & jnp.isfinite(corr), corr, 0.0)

    x_n, _ = rhs_of(var_out)
    x = x_n.at[jnp.arange(B)[:, None], basis_out].set(xB)
    if cfg.polish_pivots > 0:
        cost = dd_dot(c, x) + obj_corr
    else:
        cost = jnp.sum(c * x, axis=1)
    return BatchResult(
        x=x,
        basis=basis_out,
        cost=cost,
        iters=iters,
        status=status.astype(jnp.int32),
    )


def solve_batch_general(
    problems,
    maxiters1: int = 1000,
    maxiters2: int = 1000,
    cfg: SolverConfig = DEFAULT_CONFIG,
    presolve: bool = False,
):
    """Solve a heterogeneous batch of general-form LPs in one device batch.

    ``problems`` is a sequence of dicts with keys ``c`` and any of
    ``A, b, G, h`` (the `SimplexSolver` input surface).  Each instance is
    canonicalized on the host, padded to the common static shape
    (:func:`linprog_tpu.forms.pad_problem`), and the whole batch solves in
    one compiled two-phase computation.  Returns a list of
    :class:`LinProgResult`, one per instance, with ``x`` in each instance's
    original variable space.

    ``presolve=True`` runs the host-side structural presolve per instance
    before padding (the right place for dynamic-shape reductions:
    eliminated rows/columns shrink the COMMON padded shape).  Instances
    the presolve fully resolves (infeasible / unbounded / completely
    determined) never reach the device; the rest solve reduced and are
    postsolved back.  Bounds the presolve tightens are re-materialized as
    inequality rows (this surface has no native bounds).

    This is the batched counterpart of the reference's single-instance
    ``SimplexSolver`` front end (reference ``linprog/simplex.py:10-102``),
    which has no batch concept at all.
    """
    import numpy as np

    from . import forms
    from .results import LinProgResult

    dtype = np.dtype(cfg.dtype)

    direct = {}  # index -> LinProgResult decided by presolve
    posts = {}  # index -> (Postsolve, c_orig)
    canon = []
    canon_idx = []
    for i, p in enumerate(problems):
        c_in, A_in, b_in = p["c"], p.get("A"), p.get("b")
        G_in, h_in = p.get("G"), p.get("h")
        c_orig = np.asarray(c_in, np.float64)
        if presolve:
            from .presolve_host import presolve_problem

            red = presolve_problem(c_in, A_in, b_in, G_in, h_in)
            if red.post.status in (st.PRIMAL_INFEASIBLE,
                                   st.PRIMAL_UNBOUNDED):
                direct[i] = LinProgResult(
                    x=np.full(c_orig.shape, np.nan), basis=None,
                    cost=float("nan"), iters=0, optimum=False,
                    status=int(red.post.status),
                )
                continue
            if red.post.keep_cols.size == 0:
                x = red.post.expand(None)
                direct[i] = LinProgResult(
                    x=x, basis=None, cost=float(c_orig @ x), iters=0,
                    optimum=True, status=st.OPTIMAL,
                )
                continue
            # re-materialize tightened bounds as rows (no native bounds
            # on this surface)
            G_r, h_r = red.G, red.h
            nr = red.c.shape[0]
            ub_idx = np.flatnonzero(np.isfinite(red.ub))
            lb_idx = np.flatnonzero(red.lb > 0)
            extra_G = []
            extra_h = []
            for j in ub_idx:
                row = np.zeros(nr)
                row[j] = 1.0
                extra_G.append(row)
                extra_h.append(red.ub[j])
            for j in lb_idx:
                row = np.zeros(nr)
                row[j] = -1.0
                extra_G.append(row)
                extra_h.append(-red.lb[j])
            if extra_G:
                G_r = (np.asarray(extra_G) if G_r is None
                       else np.concatenate([G_r, np.asarray(extra_G)]))
                h_r = (np.asarray(extra_h) if h_r is None
                       else np.concatenate([h_r, np.asarray(extra_h)]))
            c_in, A_in, b_in, G_in, h_in = red.c, red.A, red.b, G_r, h_r
            posts[i] = red.post
        c_std, A_std, b_std, num_slack = forms.general_to_standard(
            c_in, A=A_in, b=b_in, G=G_in, h=h_in, dtype=dtype,
        )
        n_orig = np.asarray(c_in).shape[0]
        canon.append((c_std, A_std, b_std, n_orig))
        canon_idx.append(i)

    if not canon:  # every instance resolved by presolve
        return [direct[i] for i in range(len(problems))]

    m_pad = max(A.shape[0] for _, A, _, _ in canon)
    n_pad = max(A.shape[1] for _, A, _, _ in canon) + m_pad
    cs, As, bs = [], [], []
    for c_std, A_std, b_std, _ in canon:
        c_p, A_p, b_p, _, _ = forms.pad_problem(c_std, A_std, b_std, m_pad, n_pad)
        cs.append(c_p)
        As.append(A_p)
        bs.append(b_p)
    res = solve_batch_two_phase(
        jnp.asarray(np.stack(cs)),
        jnp.asarray(np.stack(As)),
        jnp.asarray(np.stack(bs)),
        maxiters1,
        maxiters2,
        cfg,
    )
    x = np.asarray(res.x)
    status = np.asarray(res.status)
    iters = np.asarray(res.iters)
    solved = {}
    for k, (c_std, _, _, n_orig) in enumerate(canon):
        i = canon_idx[k]
        xi = x[k, :n_orig]
        if i in posts:  # scatter eliminated variables back
            xi = posts[i].expand(xi)
        solved[i] = LinProgResult(
            x=xi,
            basis=None,
            cost=float(np.asarray(problems[i]["c"], np.float64) @ xi),
            iters=int(iters[k]),
            optimum=bool(status[k] == st.OPTIMAL),
            status=int(status[k]),
        )
    return [direct[i] if i in direct else solved[i]
            for i in range(len(problems))]


@partial(jax.jit, static_argnames=("cfg",))
def unbounded_rays(c, A, states: engine.SimplexState,
                   cfg: SolverConfig = DEFAULT_CONFIG, allowed=None):
    """Improving-ray certificates for PRIMAL_UNBOUNDED lanes.

    For each lane whose terminal status is ``PRIMAL_UNBOUNDED``, returns a
    ray ``d[B, n]`` with ``A d = 0``, ``d >= 0``, ``c'd < 0`` (the feasible
    direction of unbounded descent the engine stopped on): entering
    coordinate 1, basic coordinates ``-inv_B a_j``.  Other lanes get the
    zero vector.  Completes the certificate surface: infeasible lanes
    carry a Farkas ray in ``y`` (see :func:`solve_batch_two_phase`),
    unbounded lanes get theirs here.

    ``c``/``A``/``states`` are the arrays the engine ran on (for the
    two-phase pipeline: the Phase-II ``[A | I]`` matrix and padded cost;
    slice the leading ``n`` structural entries of the ray for the
    original space -- artificial coordinates are always 0 in it).
    """
    B, m, n = A.shape

    if allowed is None:
        allowed = jnp.ones((n,), jnp.bool_)

    def one(ci, Ai, state):
        r = engine.reduced_costs(ci, Ai, state)
        D = state.inv_B @ Ai  # [m, n] all candidate directions
        no_ascent = ~jnp.any(D > cfg.pivot_tol, axis=0)
        cand = (r < -cfg.opt_tol) & no_ascent & allowed
        j = jnp.argmax(cand)  # first certificate column
        ok = cand[j] & (state.status == st.PRIMAL_UNBOUNDED)
        basics = jnp.where(D[:, j] < 0.0, -D[:, j], 0.0)  # clip tol noise
        ray = jnp.zeros((n,), Ai.dtype).at[state.basis].set(basics)
        ray = ray.at[j].set(1.0)
        return jnp.where(ok, ray, jnp.zeros_like(ray))

    return jax.vmap(one)(c, A, states)


def unbounded_rays_from_result(c, A, result: BatchResult,
                               cfg: SolverConfig = DEFAULT_CONFIG):
    """Improving rays for a :func:`solve_batch_two_phase` result.

    Rebuilds the Phase-II arrays (``[A | I]``, padded cost) from the
    ORIGINAL ``c[B, n], A[B, m, n]`` and the result's terminal basis, and
    returns rays in the ORIGINAL structural space (``[B, n]``; zero for
    lanes that are not PRIMAL_UNBOUNDED)."""
    B, m, n = A.shape
    dt = A.dtype
    eye = jnp.broadcast_to(jnp.eye(m, dtype=dt), (B, m, m))
    A1 = jnp.concatenate([A, eye], axis=2)
    c2 = jnp.concatenate([jnp.asarray(c, dt), jnp.zeros((B, m), dt)], axis=1)
    states = jax.vmap(engine.make_state)(A1, jnp.zeros((B, m), dt),
                                         result.basis)
    states = states._replace(status=result.status)
    allowed = jnp.arange(n + m) < n  # artificials cannot carry the ray
    return unbounded_rays(c2, A1, states, cfg, allowed=allowed)[:, :n]


def batch_summary(result: BatchResult) -> dict:
    """Host-side aggregate metrics (observability; SURVEY.md section 5)."""
    import numpy as np

    status = np.asarray(result.status)
    return {
        "lanes": int(status.shape[0]),
        "optimal": int((status == st.OPTIMAL).sum()),
        "infeasible": int((status == st.PRIMAL_INFEASIBLE).sum()),
        "unbounded": int((status == st.PRIMAL_UNBOUNDED).sum()),
        "iter_limit": int((status == st.ITER_LIMIT).sum()),
        "total_pivots": int(np.asarray(result.iters).sum()),
        "max_pivots": int(np.asarray(result.iters).max()),
    }
