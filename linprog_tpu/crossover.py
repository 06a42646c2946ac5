"""First-order -> simplex crossover: snap approximate solutions to vertices.

PDHG (:mod:`linprog_tpu.pdhg`) converges to ~1e-4..1e-6 KKT residuals in
f32 but never lands on an exact basic solution; the reference's simplex
family always terminates at a vertex with a basis certificate.  This
module combines them, the way PDLP pairs its first-order solver with a
crossover step: take the approximate ``x``, guess the optimal basis (the
``m`` largest components of ``[x; s]`` -- near a non-degenerate vertex
those are exactly the basic variables), factorize it, and clean up with
batched simplex pivots.  Near the optimum the guessed basis is (almost)
DUAL feasible by construction -- its reduced costs approximate the dual
slacks ``s >= 0`` -- even when it is primal infeasible, so the cleanup is
the classic dual-then-primal re-optimization: a batched dual-simplex
phase restores primal feasibility from the guess, then a batched primal
phase finishes to optimality.  Only lanes whose guess is numerically
singular (or that exhaust the pivot budget) keep their first-order
answer and report ``crossed == False``.

Everything is batched and on-device: top-k basis guess, batched
factorization, and the same batched engine the two-phase driver uses.

Reference parity axis: the reference has no first-order family at all --
this is the capability its users would need to trust one (exception
surface + exact optima, ``/root/reference/linprog/simplex.py``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import engine
from . import status as st
from .batch import _run_chunked, _to_result
from .config import DEFAULT_CONFIG, SolverConfig
from .results import BatchResult

_HIGHEST = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("cfg", "repair_rounds"))
def crossover_batch_canonical(c, G, h, x, maxiters=512,
                              cfg: SolverConfig = DEFAULT_CONFIG,
                              indicator=None, repair_rounds: int = 2):
    """Polish approximate solutions of ``min c'x, Gx <= h, x >= 0``.

    ``c[B, n], G[B, m, n], h[B, m]``; ``x[B, n]`` the approximate primal
    points (any first-order output).  Returns ``(BatchResult, crossed)``
    where ``crossed[B]`` marks lanes that reached a verified optimal
    basis.  A primal-infeasible basis guess is repaired by a batched
    DUAL-simplex phase first (the guess is near-dual-feasible by
    construction close to an optimum; reference dual-loop semantics:
    ``/root/reference/linprog/dual_solvers.py:82-108``), then the primal
    phase finishes.  Only lanes whose guess is numerically singular get
    ``status == BASIS_PRIMAL_INFEASIBLE`` and ``crossed == False``
    immediately; lanes whose dual phase detects ``DUAL_UNBOUNDED`` (the
    guessed basis admits no primal-feasible completion) are also reported
    uncrossed.  The caller decides whether to fall back to a full
    two-phase solve.

    ``indicator`` (optional, ``[B, n+m]`` over the slack-extended space)
    overrides the basis-guess ranking: the m largest entries are taken as
    basic.  An interior-point caller should pass the Tapia indicator
    ``x/s`` (primal over dual slack) -- at a noisy f32 interior point it
    separates basic from nonbasic variables far more sharply than the
    primal magnitudes alone.

    The standard form used here keeps the rows UNFLIPPED (``A = [G I]``,
    ``b = h``): a from-basis solve needs no sign normalization, only a
    primal-feasible start.
    """
    B, m, n = G.shape
    dt = G.dtype
    if cfg.refactor_every == 0:
        # the cleanup phases start from an ALREADY factorized basis and may
        # take hundreds of pivots on a bad guess; unbounded eta drift was
        # measured to break exactly those lanes (NUMERICAL_ERROR after ~500
        # drifted pivots).  Crossover has no reference pivot-path parity
        # obligation, so a refactorization cadence is always applied.
        cfg = cfg.replace(refactor_every=128)
    eye = jnp.broadcast_to(jnp.eye(m, dtype=dt), (B, m, m))
    As = jnp.concatenate([G, eye], axis=2)  # [B, m, n+m]
    cs = jnp.concatenate([c, jnp.zeros((B, m), dt)], axis=1)

    # slack values at the approximate point; tiny PDHG infeasibilities
    # clamp to 0 so ranking is by magnitude of the intended basic value
    s = h - jnp.einsum("bmn,bn->bm", G, x, precision=_HIGHEST)
    xs = jnp.concatenate([jnp.maximum(x, 0.0), jnp.maximum(s, 0.0)], axis=1)
    if indicator is not None:
        xs = indicator

    # ---- basis guess: the m largest components of [x; s] -----------------
    _, idx = jax.lax.top_k(xs, m)  # [B, m]
    basis = jnp.sort(idx, axis=1).astype(jnp.int32)

    Bmat = jnp.take_along_axis(As, basis[:, None, :], axis=2)  # [B, m, m]
    inv_B = jnp.linalg.inv(Bmat)
    bfs0 = jnp.einsum("bij,bj->bi", inv_B, h, precision=_HIGHEST)

    finite = jnp.all(jnp.isfinite(inv_B), axis=(1, 2)) & jnp.all(
        jnp.isfinite(bfs0), axis=1
    )
    scale = jnp.maximum(1.0, jnp.max(jnp.abs(h), axis=1))
    feasible = finite & jnp.all(
        bfs0 >= -cfg.feas_tol * scale[:, None], axis=1
    )
    allowed = jnp.ones((n + m,), jnp.bool_)

    # ---- dual -> primal repair rounds --------------------------------------
    # Each round: (a) a batched dual-simplex phase repairs primal-infeasible
    # lanes from their (near-)dual-feasible factors -- lanes already primal
    # feasible skip it (status preset to OPTIMAL); (b) an exact
    # refactorization; (c) a batched primal phase finishes to optimality;
    # (d) an exact terminal solve verifies primal feasibility.  A lane the
    # engine called OPTIMAL whose EXACT bfs is still infeasible (degenerate
    # drift) re-enters the next round from its exact factors; round counts
    # beyond 2 were never observed to reopen anything.
    states = engine.SimplexState(
        basis=basis,
        inv_B=inv_B,
        bfs=bfs0,
        iters=jnp.zeros((B,), jnp.int32),
        status=jnp.where(
            finite,
            jnp.where(feasible, st.OPTIMAL, st.RUNNING),
            st.BASIS_PRIMAL_INFEASIBLE,
        ).astype(jnp.int32),
    )

    verified = jnp.zeros((B,), jnp.bool_)
    # lanes in play this round: round 1 takes every numerically sound
    # guess; later rounds only the lanes the verification REOPENED.  The
    # round-4 loop re-ran every phase -- including two full batched
    # inversions and the exact terminal solve -- over ALL lanes each
    # round, and round 2 almost never reopens anything: measured 0.35 s
    # of pure recomputation per 1024-lane m=256 chunk (35% of the
    # crossover wall).  Masking by participation and cond-guarding the
    # linalg makes the idle round cost ~one no-op engine pass.
    participate = finite
    for _round in range(max(1, repair_rounds)):
        states = _run_chunked(cs, As, h, states, allowed, maxiters, cfg,
                              "dual")

        # re-map dual outcomes: primal-feasible lanes continue to the primal
        # phase from an EXACT refactorization; DUAL_UNBOUNDED means the
        # guessed basis has no primal-feasible completion (uncrossed); a
        # lane still RUNNING exhausted the dual budget.
        to_primal = (states.status == st.OPTIMAL) & participate
        any_p = jnp.any(participate)

        def _fresh(basis):
            B_dual = jnp.take_along_axis(As, basis[:, None, :], axis=2)
            inv_fresh = jnp.linalg.inv(B_dual)
            bfs_fresh = jnp.einsum("bij,bj->bi", inv_fresh, h,
                                   precision=_HIGHEST)
            return inv_fresh, bfs_fresh

        inv_fresh, bfs_fresh = jax.lax.cond(
            any_p, _fresh,
            lambda basis: (jnp.zeros_like(states.inv_B),
                           jnp.zeros_like(states.bfs)),
            states.basis,
        )
        fresh_ok = jnp.all(jnp.isfinite(inv_fresh), axis=(1, 2)) & jnp.all(
            jnp.isfinite(bfs_fresh), axis=1
        )
        status = jnp.where(
            participate,
            jnp.where(
                to_primal,
                jnp.where(fresh_ok, st.RUNNING, st.NUMERICAL_ERROR),
                jnp.where(
                    states.status == st.DUAL_UNBOUNDED,
                    st.BASIS_PRIMAL_INFEASIBLE,
                    jnp.where(states.status == st.RUNNING, st.ITER_LIMIT,
                              states.status),
                ),
            ),
            states.status,
        ).astype(jnp.int32)
        take = (to_primal & fresh_ok)[:, None]
        states = states._replace(
            inv_B=jnp.where(take[..., None], inv_fresh, states.inv_B),
            bfs=jnp.where(take, jnp.maximum(bfs_fresh, 0.0), states.bfs),
            status=status,
        )

        # primal phase: finish to optimality
        states = _run_chunked(cs, As, h, states, allowed, maxiters, cfg,
                              "primal")

        # exact terminal solve (same accuracy pass as the two-phase driver),
        # plus a primal-feasibility verification so a lane whose drifted eta
        # factors fooled the engine can never be reported as crossed
        bfs_exact = jax.lax.cond(
            any_p,
            lambda basis: jnp.linalg.solve(
                jnp.take_along_axis(As, basis[:, None, :], axis=2),
                h[:, :, None],
            )[:, :, 0],
            lambda basis: jnp.zeros_like(states.bfs),
            states.basis,
        )
        ok = jnp.all(jnp.isfinite(bfs_exact), axis=1)
        verified_new = ok & jnp.all(
            bfs_exact >= -cfg.feas_tol * scale[:, None], axis=1
        )
        verified = jnp.where(participate, verified_new, verified)
        states = states._replace(
            bfs=jnp.where((participate & ok)[:, None], bfs_exact,
                          states.bfs),
            status=jnp.where(
                participate & ~ok, st.NUMERICAL_ERROR, states.status
            ).astype(jnp.int32),
        )
        reopen = jnp.zeros((B,), jnp.bool_)
        if _round + 1 < max(1, repair_rounds):
            # reopen OPTIMAL-but-unverified lanes with the exact bfs (its
            # negative entries are what the next dual phase repairs); the
            # running eta factor is close enough for the dual pivots and
            # gets an exact refactorization before the next primal phase
            reopen = ((states.status == st.OPTIMAL) & ~verified & ok
                      & participate)
            states = states._replace(
                status=jnp.where(reopen, st.RUNNING,
                                 states.status).astype(jnp.int32),
            )
        participate = reopen

    if cfg.polish_pivots > 0:
        # same double-word terminal polish as the two-phase driver
        # (batch.py): accurate repricing + a few dd-guided cleanup pivots
        # fix the near-optimal vertices f32 pricing cannot distinguish
        from .refine import polish_batch

        act = (states.status == st.OPTIMAL) & verified
        pbasis, pxB, _, pinv, _ = polish_batch(
            cs, As, h, states.basis, allowed, act,
            max_pivots=cfg.polish_pivots, pivot_tol=cfg.pivot_tol,
            inv_B=states.inv_B,
        )
        states = states._replace(
            basis=jnp.where(act[:, None], pbasis, states.basis),
            bfs=jnp.where(act[:, None], pxB, states.bfs),
            inv_B=jnp.where(act[:, None, None], pinv, states.inv_B),
        )

    res = _to_result(cs, states, n + m)
    crossed = (res.status == st.OPTIMAL) & verified
    if cfg.polish_pivots > 0:  # compensated objective to match the polish
        from .refine import dd_dot

        cost = dd_dot(c, res.x[:, :n])
    else:
        cost = jnp.sum(c * res.x[:, :n], axis=1)
    return (
        BatchResult(
            x=res.x[:, :n],
            basis=res.basis,
            cost=cost,
            iters=res.iters,
            status=res.status,
            y=res.y,
        ),
        crossed,
    )


def pdhg_crossover_batch_canonical(c, G, h, pdhg_maxiters: int = 20_000,
                                   crossover_maxiters: int = 512,
                                   cfg: SolverConfig = DEFAULT_CONFIG,
                                   pdhg_cfg=None):
    """Batched PDHG + crossover: first-order speed, simplex-exact optima.

    Runs :func:`pdhg.pdhg_solve_batch_canonical` (Ruiz-equilibrated PDHG),
    then :func:`crossover_batch_canonical` at the PDHG points.  Where the
    crossover verifies an optimal basis the exact vertex result replaces
    the first-order one; elsewhere the PDHG answer is kept (its status
    tells why).  Returns ``(BatchResult, crossed)``.

    A loosely-converged PDHG run (even ITER_LIMIT) often still identifies
    the optimal support -- crossover is attempted for every lane that has
    a finite iterate.
    """
    from .pdhg import DEFAULT_PDHG_CONFIG, pdhg_solve_batch_canonical

    # fixed-cadence restarts for the BATCHED first-order stage: vmap runs
    # lanes in lockstep, and adaptive primal-weight adaptation measured a
    # 4.2x straggler tail (max 17.7k vs 4.2k iters at B=1024, m=256 -->
    # 4x wall); the crossover only needs an approximate support anyway
    pdhg_cfg = pdhg_cfg or DEFAULT_PDHG_CONFIG.__class__(
        eps_rel=DEFAULT_PDHG_CONFIG.eps_rel, adaptive=False
    )
    x, cost, status, iters = pdhg_solve_batch_canonical(
        c, G, h, maxiters=pdhg_maxiters, cfg=pdhg_cfg
    )
    x = jnp.where(jnp.all(jnp.isfinite(x), axis=1)[:, None], x, 0.0)
    res, crossed = crossover_batch_canonical(
        c, G, h, x, maxiters=crossover_maxiters, cfg=cfg
    )
    merged = BatchResult(
        x=jnp.where(crossed[:, None], res.x, x),
        basis=res.basis,  # meaningful only where crossed
        cost=jnp.where(crossed, res.cost, cost),
        iters=iters + res.iters,
        status=jnp.where(crossed, res.status, status).astype(jnp.int32),
        y=res.y,
    )
    return merged, crossed


def ipm_crossover_batch_canonical(c, G, h, ipm_cfg=None,
                                  crossover_maxiters: int = 512,
                                  cfg: SolverConfig = DEFAULT_CONFIG,
                                  guess: str = "tapia"):
    """Batched interior-point + crossover: Newton-step speed, exact optima.

    Runs :func:`linprog_tpu.ipm.ipm_solve_batch_canonical` (6-10 Newton
    iterations per lane), then crosses over at the interior point.  Where
    the crossover verifies an optimal basis the exact vertex result
    replaces the interior one; elsewhere the IPM answer is kept.
    Returns ``(BatchResult, crossed)``.

    With the dual-then-primal cleanup in :func:`crossover_batch_canonical`
    a primal-infeasible basis guess is repaired instead of rejected
    (before: magnitude ranking crossed only 80/128 f32 lanes at m=n=128
    because infeasible guesses bailed; the Tapia indicator ``x/s`` was no
    better at 77/128 since the terminal state restores a mid-path
    best-KKT iterate).

    ``guess`` selects the basis-guess ranking over the slack-extended
    space: ``"tapia"`` (default) ranks by the Tapia indicator ``x/s``
    (primal over dual slack), ``"magnitude"`` by ``[x; h - Gx]`` (primal
    values), ``"slack"`` is magnitude with slack columns up-weighted.
    With the dual-then-primal repair, tapia needed fewer repair pivots
    than magnitude and crossed 32/32 vs 26/32 lanes at m=1024 -- the
    sharper support separation matters exactly where the f32 KKT floor
    degrades the magnitude ranking; "slack" crossed far fewer (4/32 at
    m=1024) and is kept only as an experiment arm.
    """
    from .ipm import DEFAULT_IPM_CONFIG, _ipm_canonical_jit

    ipm_cfg = ipm_cfg or DEFAULT_IPM_CONFIG
    B, m, n = G.shape
    dt = G.dtype
    cs = jnp.concatenate([c, jnp.zeros((B, m), dt)], axis=1)
    state = _ipm_canonical_jit(cs, G, h, ipm_cfg)
    x = state.x[:, :n].astype(dt)
    x = jnp.where(jnp.all(jnp.isfinite(x), axis=1)[:, None], x, 0.0)
    if guess == "tapia":
        ind = state.x / jnp.maximum(state.s, 1e-30)
        ind = jnp.where(
            jnp.all(jnp.isfinite(ind), axis=1)[:, None], ind, 0.0
        ).astype(dt)
    elif guess == "slack":
        s_pr = jnp.maximum(
            h - jnp.einsum("bmn,bn->bm", G, x, precision=_HIGHEST), 0.0
        )
        scale = jnp.maximum(1.0, jnp.max(jnp.abs(h), axis=1))[:, None]
        # slacks win any tie within ~1e-3 of the magnitude ranking
        ind = jnp.concatenate(
            [jnp.maximum(x, 0.0), s_pr + 1e-3 * scale], axis=1
        )
    elif guess == "magnitude":
        # the ranking crossover_batch_canonical computes without an
        # indicator, passed explicitly so every guess shares one compile
        s_pr = h - jnp.einsum("bmn,bn->bm", G, x, precision=_HIGHEST)
        ind = jnp.concatenate(
            [jnp.maximum(x, 0.0), jnp.maximum(s_pr, 0.0)], axis=1
        )
    else:
        raise ValueError(f"unknown basis guess {guess!r}")
    res, crossed = crossover_batch_canonical(
        c, G, h, x, maxiters=crossover_maxiters, cfg=cfg, indicator=ind,
    )
    ipm_cost = jnp.sum(cs * state.x, axis=1).astype(dt)
    merged = BatchResult(
        x=jnp.where(crossed[:, None], res.x, x),
        basis=res.basis,  # meaningful only where crossed
        cost=jnp.where(crossed, res.cost, ipm_cost),
        iters=state.iters + res.iters,
        status=jnp.where(crossed, res.status, state.status).astype(jnp.int32),
        y=res.y,
    )
    return merged, crossed
