"""PDHG (PDLP-style) first-order LP solver -- the second solver family.

The simplex engines are exact and pivot-bound; for very large instances the
accelerator-native approach is a matrix-free first-order method (PDLP /
cuPDLP line of work -- see PAPERS.md).  This is a restarted average-iterate
primal-dual hybrid gradient for

    min c'x   s.t.  A x = b,  G x <= h,  lb <= x <= ub

Everything is matvecs + projections -- accelerator-friendly, fully jittable,
batched with one ``vmap``, sharded like any other batch.  Iteration
(Chambolle-Pock with extrapolation, constraints stacked as K x ~ q):

    L(x, y) = c'x + y'(Kx - q),  Y = {y : y_ineq >= 0}   (ineq rows: Kx <= q)
    x+ = proj_[lb,ub](x - tau (c + K'y))
    y+ = proj_Y(y + sigma (K (2 x+ - x) - q))

with ``proj_Y`` the identity on equality duals and ``max(0, .)`` on
inequality duals, and ``tau sigma ||K||^2 <= 1`` via a power-iteration
estimate of ``||K||``.  Fixed-frequency restarts to the running average
iterate give the ergodic O(1/k) -> linear-ish practical behavior of PDLP's
restart scheme (simplified: fixed cadence instead of adaptive).

Termination: relative KKT residuals (primal feasibility, dual feasibility,
duality gap), checked on-device every ``check_every`` iterations.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import status as st
from .results import LinProgResult

# Reduced-precision f32 matmuls (TF32 on NVIDIA tensor cores) make PDHG's
# KKT residuals plateau above eps_rel, so the iteration never terminates.
# All matvecs force full f32 precision.
_HIGHEST = jax.lax.Precision.HIGHEST


class SharedPatternSparse(NamedTuple):
    """Sparse [m, n] matrix as shared COO indices + (possibly traced) values.

    The batched-sparse PDHG path stores ONE copy of the sparsity pattern
    (``rows``/``cols``, int32 [nnz]) for the whole batch and per-lane
    ``vals`` [nnz] -- the natural layout for structured LP families
    (transportation, covering, ...) where every instance shares a pattern.
    Matvecs are gather + ``segment_sum``: plain f32 accumulation, no
    reduced-precision matmul caveat, FLOPs and memory O(nnz).  Duck-types the small part
    of the dense-array interface :func:`_pdhg_core` touches (``shape``,
    ``dtype``, ``.T``, matvec via :func:`_mv`).
    """

    rows: jax.Array  # i32 [nnz]
    cols: jax.Array  # i32 [nnz]
    vals: jax.Array  # [nnz]
    m: int
    n: int
    transposed: bool = False

    @property
    def shape(self):
        return (self.n, self.m) if self.transposed else (self.m, self.n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def T(self) -> "SharedPatternSparse":
        return self._replace(transposed=not self.transposed)

    def mv(self, v):
        out_idx = self.cols if self.transposed else self.rows
        in_idx = self.rows if self.transposed else self.cols
        return jax.ops.segment_sum(
            self.vals * v[in_idx], out_idx, num_segments=self.shape[0]
        )


def _mv(M, v):
    if isinstance(M, SharedPatternSparse):
        return M.mv(v)
    try:
        from jax.experimental import sparse as jsparse

        if isinstance(M, jsparse.BCOO):
            # sparse matvec lowers to gather + segment-sum: plain f32
            # accumulation, no reduced-precision matmul caveat
            return M @ v
    except ImportError:  # pragma: no cover
        pass
    return jnp.matmul(M, v, precision=_HIGHEST)


@dataclasses.dataclass(frozen=True)
class PDHGConfig:
    eps_rel: float = 1e-4
    maxiters: int = 100_000
    check_every: int = 64
    restart_every: int = 512  # backstop cadence (adaptive restart may fire earlier)
    power_iters: int = 30
    omega: float = 1.0  # primal weight: tau = omega/||K||, sigma = 1/(omega ||K||)
    dtype: str = "float32"
    # PDLP-style adaptivity (round 2): restart to the better of
    # current/average iterate when its KKT score decayed by restart_beta
    # since the last restart; primal weight omega re-estimated from
    # ||dy||/||dx|| over the epoch.  Infeasibility certificates extracted
    # from the normalized epoch movement direction with tolerance
    # eps_infeas.  Set adaptive=False for the fixed-cadence round-1 scheme.
    adaptive: bool = True
    restart_beta: float = 0.4
    eps_infeas: float = 1e-6
    omega_clip: float = 64.0  # omega confined to [1/clip, clip]
    # reset omega to 1 on a restart whose KKT score decayed by less than
    # this factor since the previous restart (stalled lane: the movement
    # ratio is noise and omega random-walks to the clip; see
    # check_and_restart).  >= 1 disables the reset.
    stall_reset_beta: float = 0.95
    # Reflected Halpern acceleration (cuPDLPx / rHPDHG):
    #   z_{k+1} = (k+1)/(k+2) * (2 T(z_k) - z_k) + 1/(k+2) * z_anchor
    # with the anchor reset at restarts, replacing average-iterate
    # restarts.  Accelerates the last iterate; termination/restart
    # candidates are evaluated at T(z) (the PDHG-step image), which is
    # also what solve() reports.
    halpern: bool = False
    # iteration budget for the accelerated phase: a lane still running
    # after this many iterations reverts permanently to averaged
    # restarts (the Halpern last iterate can circle the f32 KKT noise
    # floor with oscillating scores the stall detector cannot catch;
    # measured ~0.4% of f32 batched lanes at m=256).  Single instances
    # terminate far below this.
    halpern_patience: int = 10_000

    @property
    def jnp_dtype(self):
        return {"float32": jnp.float32, "float64": jnp.float64}[self.dtype]


DEFAULT_PDHG_CONFIG = PDHGConfig()


class PDHGState(NamedTuple):
    x: jax.Array  # [n]
    y: jax.Array  # [m_eq + m_ineq]
    x_sum: jax.Array  # running sums for average-iterate restarts
    y_sum: jax.Array
    inner_count: jax.Array  # iterations since last restart
    iters: jax.Array
    status: jax.Array
    omega: jax.Array  # [] primal weight (adapted at restarts)
    x_anchor: jax.Array  # [n] iterate at last restart (epoch movement /
    y_anchor: jax.Array  # [m]  certificate direction / omega adaptation)
    last_score: jax.Array  # [] KKT score at last restart
    halpern_off: jax.Array  # [] bool: lane reverted to averaged restarts
    # (per-lane safety net: Halpern's last iterate can stall at the f32
    # KKT noise floor; a no-progress restart flips the lane back)


def _estimate_norm(K, iters: int, seed: int = 0):
    """Power iteration for ||K||_2 (device-side, jittable)."""
    v = jax.random.normal(jax.random.PRNGKey(seed), (K.shape[1],), K.dtype)

    def body(_, v):
        w = _mv(K, v)
        u = _mv(K.T, w)
        return u / jnp.maximum(jnp.linalg.norm(u), 1e-30)

    v = lax.fori_loop(0, iters, body, v / jnp.linalg.norm(v))
    return jnp.linalg.norm(_mv(K, v)) / jnp.maximum(jnp.linalg.norm(v), 1e-30)


def _kkt_residuals(c, K, q, n_eq, lb, ub, x, y):
    """Relative KKT residuals (primal, dual, gap)."""
    Kx = _mv(K, x)
    # primal: equality rows exact, inequality rows one-sided (Kx <= q)
    viol = Kx - q
    m = q.shape[0]
    is_ineq = jnp.arange(m) >= n_eq
    pr = jnp.where(is_ineq, jnp.maximum(viol, 0.0), viol)
    primal_res = jnp.linalg.norm(pr) / (1.0 + jnp.linalg.norm(q))
    # dual: lambda = c + K'y is the reduced cost absorbed by bound
    # multipliers; lambda > 0 needs a finite lb, lambda < 0 a finite ub.
    lam = c + _mv(K.T, y)
    lam_minus = jnp.minimum(lam, 0.0)
    lam_plus = jnp.maximum(lam, 0.0)
    du = jnp.where(jnp.isfinite(ub), 0.0, lam_minus) + jnp.where(
        jnp.isfinite(lb), 0.0, lam_plus
    )
    dual_res = jnp.linalg.norm(du) / (1.0 + jnp.linalg.norm(c))
    # gap: c'x vs dual objective -q'y + sum_j min_{x_j in [lb,ub]} lam_j x_j
    contrib = jnp.where(
        lam >= 0,
        jnp.where(jnp.isfinite(lb), lam * lb, 0.0),
        jnp.where(jnp.isfinite(ub), lam * ub, 0.0),
    )
    dual_obj = -q @ y + jnp.sum(contrib)
    primal_obj = c @ x
    gap = jnp.abs(primal_obj - dual_obj) / (
        1.0 + jnp.abs(primal_obj) + jnp.abs(dual_obj)
    )
    return primal_res, dual_res, gap


def _pdhg_core(c, K, q, n_eq, lb, ub, cfg: PDHGConfig):
    """Build (init_state, run) for one problem instance (jit-friendly)."""
    m, n = K.shape
    is_ineq = (jnp.arange(m) >= n_eq)
    norm_K = _estimate_norm(K, cfg.power_iters)
    norm_K = jnp.maximum(norm_K, 1e-12)
    if cfg.halpern:
        # the reflected operator 2T - I COMPOUNDS any slight
        # expansiveness of T: when the power iteration underestimates
        # ||K|| (tau sigma ||K||^2 marginally > 1), plain PDHG still
        # limps along but the Halpern reflection diverges geometrically
        # (observed: KKT score 5e12 within 512 iterations on ~0.4% of
        # lanes, after which the f32 iterate freezes by absorption).
        # A 5% step-size safety margin covers the estimator error.
        norm_K = norm_K * 1.05
    finite_lb = jnp.isfinite(lb)
    finite_ub = jnp.isfinite(ub)

    def project_x(x):
        return jnp.clip(x, lb, ub)

    def project_y(y):
        return jnp.where(is_ineq, jnp.maximum(y, 0.0), y)

    def apply_T(x, y, omega):
        """One PDHG operator application (Chambolle-Pock with
        extrapolation)."""
        tau = omega / norm_K
        sigma = 1.0 / (omega * norm_K)
        x_new = project_x(x - tau * (c + _mv(K.T, y)))
        y_new = project_y(y + sigma * (_mv(K, 2.0 * x_new - x) - q))
        return x_new, y_new

    def step(state: PDHGState) -> PDHGState:
        x, y = state.x, state.y
        xT, yT = apply_T(x, y, state.omega)
        if cfg.halpern:
            # reflected Halpern: anchor pull with weight 1/(k+2);
            # reverted lanes (halpern_off) run the plain PDHG step
            k = state.inner_count.astype(x.dtype)
            lam = (k + 1.0) / (k + 2.0)
            x_h = lam * (2.0 * xT - x) + (1.0 - lam) * state.x_anchor
            y_h = lam * (2.0 * yT - y) + (1.0 - lam) * state.y_anchor
            x_new = jnp.where(state.halpern_off, xT, x_h)
            y_new = jnp.where(state.halpern_off, yT, y_h)
        else:
            x_new, y_new = xT, yT
        return state._replace(
            x=x_new,
            y=y_new,
            x_sum=state.x_sum + x_new,
            y_sum=state.y_sum + y_new,
            inner_count=state.inner_count + 1,
            iters=state.iters + 1,
        )

    def kkt_score(x, y):
        pr, du, gap = _kkt_residuals(c, K, q, n_eq, lb, ub, x, y)
        return pr, du, gap, jnp.sqrt(pr * pr + du * du + gap * gap)

    def _certificates(state: PDHGState):
        """Infeasibility certificates from the epoch movement direction.

        On infeasible/unbounded instances the PDHG iterates diverge along a
        ray; the normalized movement since the last restart converges to a
        Farkas certificate (PDLP's detection scheme).
        """
        tiny = jnp.asarray(1e-30, K.dtype)
        eps = cfg.eps_infeas
        # ---- dual ray => primal infeasible --------------------------------
        dy = state.y - state.y_anchor
        ny = jnp.linalg.norm(dy)
        yhat = project_y(dy / jnp.maximum(ny, tiny))
        lam = _mv(K.T, yhat)  # homogeneous reduced costs
        lam_plus = jnp.maximum(lam, 0.0)
        lam_minus = jnp.minimum(lam, 0.0)
        # components not absorbable by a finite bound must vanish
        infeas_res = jnp.linalg.norm(
            jnp.where(finite_lb, 0.0, lam_plus)
            + jnp.where(finite_ub, 0.0, lam_minus)
        )
        rayval = -q @ yhat + jnp.sum(
            jnp.where(finite_lb, lam_plus * lb, 0.0)
            + jnp.where(finite_ub, lam_minus * ub, 0.0)
        )
        primal_infeas = (
            (ny > 1.0)  # genuinely diverging, not noise
            & (infeas_res <= eps * (1.0 + jnp.linalg.norm(yhat)))
            & (rayval > eps)
        )
        # ---- primal ray => primal unbounded (dual infeasible) -------------
        dx = state.x - state.x_anchor
        nx = jnp.linalg.norm(dx)
        xhat = dx / jnp.maximum(nx, tiny)
        # recession cone of [lb, ub]
        xhat = jnp.where(finite_lb, jnp.maximum(xhat, 0.0), xhat)
        xhat = jnp.where(finite_ub, jnp.minimum(xhat, 0.0), xhat)
        Kx = _mv(K, xhat)
        ray_res = jnp.linalg.norm(
            jnp.where(is_ineq, jnp.maximum(Kx, 0.0), Kx)
        )
        unbounded = (
            (nx > 1.0)
            & (ray_res <= eps * (1.0 + jnp.linalg.norm(xhat)))
            & ((c @ xhat) < -eps)
        )
        return primal_infeas, unbounded

    def check_and_restart(state: PDHGState) -> PDHGState:
        cnt = jnp.maximum(state.inner_count, 1)
        if cfg.halpern:
            # candidates live at T(z): z converges to a fixed point of T,
            # and T(z) is feasible w.r.t. the box/cone projections (the
            # raw Halpern iterate need not be).  Reverted lanes keep the
            # averaged candidate (the sums accumulate either way).
            x_cur, y_cur = apply_T(state.x, state.y, state.omega)
            off = state.halpern_off
            x_avg = jnp.where(off, state.x_sum / cnt, x_cur)
            y_avg = jnp.where(off, state.y_sum / cnt, y_cur)
        else:
            x_cur, y_cur = state.x, state.y
            x_avg = state.x_sum / cnt
            y_avg = state.y_sum / cnt
        pr_c, du_c, gap_c, s_cur = kkt_score(x_cur, y_cur)
        pr_a, du_a, gap_a, s_avg = kkt_score(x_avg, y_avg)

        # terminate on whichever iterate satisfies the tolerance
        ok_cur = (pr_c < cfg.eps_rel) & (du_c < cfg.eps_rel) & (
            gap_c < cfg.eps_rel
        )
        ok_avg = (pr_a < cfg.eps_rel) & (du_a < cfg.eps_rel) & (
            gap_a < cfg.eps_rel
        )
        adopt_avg_final = ok_avg & ~ok_cur
        ok = ok_cur | ok_avg

        if cfg.adaptive:
            infeas, unbnd = _certificates(state)
        else:
            infeas = unbnd = jnp.zeros((), bool)
        running = state.status == st.RUNNING
        status = jnp.where(
            running & ok,
            st.OPTIMAL,
            jnp.where(
                running & infeas,
                st.PRIMAL_INFEASIBLE,
                jnp.where(running & unbnd, st.PRIMAL_UNBOUNDED, state.status),
            ),
        ).astype(jnp.int32)

        # ---- restart decision --------------------------------------------
        avg_better = s_avg < s_cur
        s_cand = jnp.minimum(s_avg, s_cur)
        if cfg.adaptive:
            do = (s_cand <= cfg.restart_beta * state.last_score) | (
                state.inner_count >= cfg.restart_every
            )
        else:
            do = state.inner_count >= cfg.restart_every
        do = do & running & ~ok
        if cfg.halpern:
            # a Halpern restart re-anchors at the PDHG-step image T(z);
            # reverted lanes follow the averaged-restart adoption rule
            restart_x = jnp.where(
                off, jnp.where(avg_better, x_avg, state.x), x_cur
            )
            restart_y = jnp.where(
                off, jnp.where(avg_better, y_avg, state.y), y_cur
            )
            x_new = jnp.where(do, restart_x, state.x)
            y_new = jnp.where(do, restart_y, state.y)
            # safety nets: a no-progress restart, or exhausting the
            # accelerated-phase iteration budget (scores can oscillate
            # around the f32 noise floor without ever "stalling"),
            # reverts the lane to averaged restarts permanently
            off = off | (do & (s_cand > cfg.stall_reset_beta
                               * state.last_score))
            off = off | (running & (state.iters >= cfg.halpern_patience))
        else:
            x_new = jnp.where(do & avg_better, x_avg, state.x)
            y_new = jnp.where(do & avg_better, y_avg, state.y)

        # ---- primal weight adaptation (PDLP: log-space smoothing) --------
        if cfg.adaptive:
            dxn = jnp.linalg.norm(x_new - state.x_anchor)
            dyn = jnp.linalg.norm(y_new - state.y_anchor)
            both = (dxn > 1e-12) & (dyn > 1e-12)
            ratio = jnp.where(both, dyn / jnp.maximum(dxn, 1e-30), 1.0)
            omega_prop = jnp.exp(
                0.5 * jnp.log(ratio) + 0.5 * jnp.log(state.omega)
            )
            omega_prop = jnp.clip(
                omega_prop, 1.0 / cfg.omega_clip, cfg.omega_clip
            )
            omega = jnp.where(do & both, omega_prop, state.omega)
            # stall reset: a BACKSTOP restart whose KKT score barely moved
            # since the previous restart means the adapted weight is
            # hurting, not helping -- the movement ratio is then noise and
            # the log-space update random-walks omega to the clip while
            # the score stalls just above eps_rel (observed: 20x iteration
            # tails on ~2% of batched lanes).  Reset to the balanced
            # weight; a lane that genuinely needs omega far from 1 will
            # re-adapt within a few restarts.
            stalled = do & (s_cand > cfg.stall_reset_beta * state.last_score)
            omega = jnp.where(stalled, jnp.ones_like(omega), omega)
        else:
            omega = state.omega

        zx = jnp.zeros_like(state.x_sum)
        zy = jnp.zeros_like(state.y_sum)
        if cfg.halpern:  # report the feasible T(z) image on termination
            final_x = jnp.where(ok, x_cur, x_new)
            final_y = jnp.where(ok, y_cur, y_new)
        else:
            final_x = jnp.where(adopt_avg_final, x_avg, x_new)
            final_y = jnp.where(adopt_avg_final, y_avg, y_new)
        return state._replace(
            x=final_x,
            y=final_y,
            x_sum=jnp.where(do, zx, state.x_sum),
            y_sum=jnp.where(do, zy, state.y_sum),
            inner_count=jnp.where(do, 0, state.inner_count),
            status=status,
            omega=omega,
            x_anchor=jnp.where(do, final_x, state.x_anchor),
            y_anchor=jnp.where(do, final_y, state.y_anchor),
            last_score=jnp.where(do, s_cand, state.last_score),
            halpern_off=(off if cfg.halpern else state.halpern_off),
        )

    def init_state() -> PDHGState:
        x0 = project_x(jnp.zeros(n, K.dtype))
        return PDHGState(
            x=x0,
            y=jnp.zeros(m, K.dtype),
            x_sum=jnp.zeros(n, K.dtype),
            y_sum=jnp.zeros(m, K.dtype),
            inner_count=jnp.zeros((), jnp.int32),
            iters=jnp.zeros((), jnp.int32),
            status=jnp.zeros((), jnp.int32),
            omega=jnp.asarray(cfg.omega, K.dtype),
            x_anchor=x0,
            y_anchor=jnp.zeros(m, K.dtype),
            last_score=jnp.asarray(jnp.inf, K.dtype),
            halpern_off=jnp.zeros((), jnp.bool_),
        )

    def run(state: PDHGState, maxiters) -> PDHGState:
        maxiters = jnp.asarray(maxiters, jnp.int32)

        def cond(s):
            return (s.status == st.RUNNING) & (s.iters < maxiters)

        def body(s):
            s = lax.fori_loop(0, cfg.check_every, lambda _, t: step(t), s)
            return check_and_restart(s)

        return lax.while_loop(cond, body, state)

    return init_state, run


def _canonicalize(c, A, b, G, h, lb, ub, dtype):
    c = np.asarray(c, dtype=dtype)
    n = c.shape[0]
    rows = []
    rhs = []
    n_eq = 0
    if A is not None and b is not None:
        A = np.atleast_2d(np.asarray(A, dtype=dtype))
        rows.append(A)
        rhs.append(np.asarray(b, dtype=dtype))
        n_eq = A.shape[0]
    if G is not None and h is not None:
        G = np.atleast_2d(np.asarray(G, dtype=dtype))
        rows.append(G)
        rhs.append(np.asarray(h, dtype=dtype))
    if not rows:
        raise ValueError("need (A, b) and/or (G, h)")
    K = np.concatenate(rows, axis=0)
    q = np.concatenate(rhs)
    lb = np.zeros(n, dtype=dtype) if lb is None else np.asarray(lb, dtype=dtype)
    ub = (
        np.full(n, np.inf, dtype=dtype)
        if ub is None
        else np.asarray(ub, dtype=dtype)
    )
    return c, K, q, n_eq, lb, ub


@partial(jax.jit, static_argnames=("n_eq", "cfg"))
def _solve_jit(c, K, q, n_eq, lb, ub, maxiters, cfg: PDHGConfig):
    init_state, run = _pdhg_core(c, K, q, n_eq, lb, ub, cfg)
    return run(init_state(), maxiters)


class PDHGSolver:
    """First-order LP solver with the general-form input surface.

    ``min c'x  s.t.  Ax = b, Gx <= h, lb <= x <= ub`` -- same signature as
    :class:`linprog_tpu.SimplexSolver`, different algorithmic regime:
    moderate accuracy (``eps_rel``), excellent scaling (pure matvecs).
    """

    def __init__(self, c, A=None, b=None, G=None, h=None, lb=None, ub=None,
                 config: Optional[PDHGConfig] = None):
        self.config = config or DEFAULT_PDHG_CONFIG
        dtype = np.dtype(self.config.dtype)
        c, K, q, n_eq, lb_, ub_ = _canonicalize(c, A, b, G, h, lb, ub, dtype)
        self.c = jnp.asarray(c)
        self.K = jnp.asarray(K)
        self.q = jnp.asarray(q)
        self.n_eq = n_eq
        self.lb = jnp.asarray(lb_)
        self.ub = jnp.asarray(ub_)

    def solve(self, maxiters: Optional[int] = None) -> LinProgResult:
        maxiters = maxiters or self.config.maxiters
        state = _solve_jit(
            self.c, self.K, self.q, self.n_eq, self.lb, self.ub,
            jnp.asarray(maxiters, jnp.int32), self.config,
        )
        self._state = state
        x = np.asarray(state.x)
        code = int(state.status)
        return LinProgResult(
            x=x,
            basis=None,
            cost=float(np.asarray(self.c) @ x),
            iters=int(state.iters),
            optimum=code == st.OPTIMAL,
            status=code if code != st.RUNNING else st.ITER_LIMIT,
            y=np.asarray(state.y),
        )

    @property
    def duals(self) -> np.ndarray:
        """Dual iterate ``y`` (eq rows first, then ineq rows); solve first."""
        if not hasattr(self, "_state"):
            raise AttributeError("call solve() first")
        return np.asarray(self._state.y)


def pdhg_solve_batch(c, K, q, n_eq: int, lb, ub, maxiters: int = 100_000,
                     cfg: PDHGConfig = DEFAULT_PDHG_CONFIG):
    """Batched PDHG over same-shape instances: ``c[B,n], K[B,m,n], q[B,m]``.

    Returns the final :class:`PDHGState` with a leading batch dim.
    """

    @partial(jax.jit, static_argnames=("n_eq", "cfg"))
    def _batch(c, K, q, n_eq, lb, ub, maxiters, cfg):
        def one(ci, Ki, qi, lbi, ubi):
            init_state, run = _pdhg_core(ci, Ki, qi, n_eq, lbi, ubi, cfg)
            return run(init_state(), maxiters)

        return jax.vmap(one)(c, K, q, lb, ub)

    return _batch(c, K, q, n_eq, lb, ub, jnp.asarray(maxiters, jnp.int32), cfg)


def pdhg_solve_sparse(c, K, q, n_eq: int = 0, lb=None, ub=None,
                      maxiters: int = 100_000,
                      cfg: PDHGConfig = DEFAULT_PDHG_CONFIG) -> LinProgResult:
    """First-order solve with a SPARSE constraint matrix.

    ``K`` is a ``jax.experimental.sparse.BCOO`` [m, n] stacking equality
    rows (first ``n_eq``) then ``<=`` rows; ``q`` the matching rhs.  The
    iteration is matrix-free (only ``K @ v`` / ``K.T @ v``), so memory and
    FLOPs scale with nnz -- the regime where dense simplex cannot even store
    ``A``.  Sparse matvecs accumulate in plain f32 (gather + segment-sum),
    so no reduced-precision matmul caveat applies.
    """
    m, n = K.shape
    dtype = cfg.jnp_dtype
    c = jnp.asarray(c, dtype)
    q = jnp.asarray(q, dtype)
    lb = jnp.zeros(n, dtype) if lb is None else jnp.asarray(lb, dtype)
    ub = jnp.full(n, jnp.inf, dtype) if ub is None else jnp.asarray(ub, dtype)
    state = _solve_jit(
        c, K, q, n_eq, lb, ub, jnp.asarray(maxiters, jnp.int32), cfg
    )
    x = np.asarray(state.x)
    code = int(state.status)
    return LinProgResult(
        x=x,
        basis=None,
        cost=float(np.asarray(c) @ x),
        iters=int(state.iters),
        optimum=code == st.OPTIMAL,
        status=code if code != st.RUNNING else st.ITER_LIMIT,
        y=np.asarray(state.y),
    )


def pdhg_solve_batch_sparse(c, rows, cols, vals, q, n_eq: int, lb, ub,
                            shape: tuple, maxiters: int = 100_000,
                            cfg: PDHGConfig = DEFAULT_PDHG_CONFIG):
    """Batched SPARSE PDHG over instances sharing one sparsity pattern.

    ``c[B, n], vals[B, nnz], q[B, m], lb[B, n], ub[B, n]`` with the COO
    pattern ``rows/cols[nnz]`` (int32) shared across the batch and
    ``shape = (m, n)``.  One pattern copy serves the whole batch, so
    memory is ``O(nnz * B)`` values + ``O(nnz)`` indices -- the regime
    where a dense ``K[B, m, n]`` no longer fits (e.g. 1024 lanes of
    m=n=2048 at 1% density: 0.7 GB sparse vs 17 TB dense).  The iteration
    is the exact same adaptive-restart PDHG as the dense batch
    (:func:`pdhg_solve_batch`); only the matvec representation differs.

    Returns the final :class:`PDHGState` with a leading batch dim.
    """
    m, n = shape
    dtype = cfg.jnp_dtype
    rows = jnp.asarray(rows, jnp.int32)
    cols = jnp.asarray(cols, jnp.int32)
    return _sparse_batch_jit(
        jnp.asarray(c, dtype), rows, cols, jnp.asarray(vals, dtype),
        jnp.asarray(q, dtype), jnp.asarray(lb, dtype),
        jnp.asarray(ub, dtype), jnp.asarray(maxiters, jnp.int32),
        m, n, n_eq, cfg,
    )


@partial(jax.jit, static_argnames=("m", "n", "n_eq", "cfg"))
def _sparse_batch_jit(c, rows, cols, vals, q, lb, ub, maxiters, m, n, n_eq,
                      cfg: PDHGConfig):
    def one(ci, vi, qi, lbi, ubi):
        K = SharedPatternSparse(rows, cols, vi, m, n)
        init_state, run = _pdhg_core(ci, K, qi, n_eq, lbi, ubi, cfg)
        return run(init_state(), maxiters)

    return jax.vmap(one)(c, vals, q, lb, ub)


@partial(jax.jit, static_argnames=("cfg",))
def pdhg_solve_batch_canonical(c, G, h, maxiters: int = 100_000,
                               cfg: PDHGConfig = DEFAULT_PDHG_CONFIG):
    """Batched PDHG for canonical ``min c'x, Gx <= h, x >= 0`` with
    automatic Ruiz equilibration (PDHG convergence is scaling-sensitive;
    PDLP always equilibrates).

    ``c[B, n], G[B, m, n], h[B, m]``.  Returns ``(x[B, n], cost[B],
    status[B], iters[B])`` in the ORIGINAL scaling.
    """
    from .presolve import ruiz_equilibrate, unscale_solution

    B, m, n = G.shape
    cs, Gs, hs, sc = ruiz_equilibrate(c, G, h)
    # x >= 0 maps to z >= 0 under positive column scales
    lb = jnp.zeros((B, n), G.dtype)
    ub = jnp.full((B, n), jnp.inf, G.dtype)

    def one(ci, Ki, qi, lbi, ubi):
        init_state, run = _pdhg_core(ci, Ki, qi, 0, lbi, ubi, cfg)
        return run(init_state(), jnp.asarray(maxiters, jnp.int32))

    states = jax.vmap(one)(cs, Gs, hs, lb, ub)
    x = unscale_solution(states.x, sc)
    cost = jnp.sum(c * x, axis=1)
    status = jnp.where(
        states.status == st.RUNNING, st.ITER_LIMIT, states.status
    ).astype(jnp.int32)
    return x, cost, status, states.iters
