"""Shared-pattern sparse batched IPM (linprog_tpu.ipm_sparse).

The sparse operator must agree with the dense slack operator on a
densified copy of the same instances (unit level), and the end-to-end
sparse solve must match the dense IPM and the SciPy HiGHS f64 oracle
(capability level).  Mirrors the sparse-PDHG test strategy at the IPM's
better accuracy class.
"""

import numpy as np
import pytest

scipy_opt = pytest.importorskip("scipy.optimize")

import jax
import jax.numpy as jnp

from linprog_tpu import status as stt
from linprog_tpu.generators import (
    device_sparse_inequality_lps,
    random_sparse_inequality_lps,
)
from linprog_tpu.ipm import IPMConfig, _SlackOp, ipm_solve_batch_canonical
from linprog_tpu.ipm_sparse import (
    SparsePattern,
    _SparseSlackOp,
    ipm_solve_batch_sparse_canonical,
)

B, M, N, DENS = 8, 48, 48, 0.15


def _instances(seed=5):
    c, rows, cols, vals, h = random_sparse_inequality_lps(
        B, M, N, DENS, seed=seed
    )
    G = np.zeros((B, M, N), np.float32)
    G[:, rows, cols] = vals
    return c, rows, cols, vals, h, G


def _densify(rows, cols, vals, like):
    G = np.zeros(like.shape, np.float32)
    G[:, rows, cols] = vals
    return G


def _dev_pattern(pat):
    return {
        k: jnp.asarray(getattr(pat, k))
        for k in ("row_cols", "row_slot", "row_mask", "col_rows",
                  "col_slot", "col_mask", "pair_perm", "pair_ids")
    }


def test_sparse_op_matches_dense_slack_op():
    c, rows, cols, vals, h, G = _instances()
    pat = SparsePattern(rows, cols, M, N)
    op = _SparseSlackOp(_dev_pattern(pat), jnp.asarray(vals), M, N)
    dop = _SlackOp(jnp.asarray(G))
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.random((B, N + M)), jnp.float32)
    w = jnp.asarray(rng.random((B, M)), jnp.float32)
    d = jnp.asarray(0.1 + rng.random((B, N + M)), jnp.float32)
    assert float(jnp.max(jnp.abs(op.mv(v) - dop.mv(v)))) < 1e-4
    assert float(jnp.max(jnp.abs(op.mtv(w) - dop.mtv(w)))) < 1e-4
    # the pair-scatter normal assembly is the device-critical piece
    assert float(jnp.max(jnp.abs(op.normal(d) - dop.normal(d)))) < 1e-3
    assert np.allclose(
        np.asarray(op.max_abs()), np.asarray(dop.max_abs()), rtol=1e-6
    )


def test_sparse_ipm_matches_dense_and_highs():
    c, rows, cols, vals, h, G = _instances()
    cfg = IPMConfig(eps_rel=1e-3, maxiters=40)
    res_s = ipm_solve_batch_sparse_canonical(
        c, rows, cols, vals, h, (M, N), cfg
    )
    res_d = ipm_solve_batch_canonical(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), cfg
    )
    ns = int((np.asarray(res_s.status) == stt.OPTIMAL).sum())
    nd = int((np.asarray(res_d.status) == stt.OPTIMAL).sum())
    assert ns >= B - 1 and nd >= B - 1
    gaps = []
    for i in range(B):
        ref = scipy_opt.linprog(
            c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None), method="highs"
        )
        if ref.status == 0:
            gaps.append(
                abs(float(res_s.cost[i]) - ref.fun) / max(1, abs(ref.fun))
            )
    assert gaps and max(gaps) < 5e-3


def test_sparse_ipm_infeasible_certificate():
    """Farkas grading runs through the sparse operator too: an infeasible
    sparse instance must be flagged, not returned as a bogus optimum."""
    c, rows, cols, vals, h, G = _instances(seed=9)
    # x >= 0 with a row forcing  (sum of nonneg combo) <= negative:
    # make one row's values all positive and its rhs negative
    r0 = rows == rows[0]
    vals = vals.copy()
    vals[:, r0] = np.abs(vals[:, r0]) + 0.1
    h = h.copy()
    h[:, rows[0]] = -1.0
    cfg = IPMConfig(eps_rel=1e-3, maxiters=40)
    # equilibrate=False: this arm pins EXACT verdict parity with the dense
    # operator on the same data (the scaled system grades differently)
    res = ipm_solve_batch_sparse_canonical(
        c, rows, cols, vals, h, (M, N), cfg, equilibrate=False
    )
    status = np.asarray(res.status)
    # no lane may read OPTIMAL; the Farkas tolerance certifies a subset at
    # f32 (the rest close as ITER_LIMIT) -- must match the DENSE IPM's
    # verdicts exactly on the densified copies (operator parity)
    assert (status == stt.OPTIMAL).sum() == 0
    assert (status == stt.PRIMAL_INFEASIBLE).sum() >= 1
    res_d = ipm_solve_batch_canonical(
        jnp.asarray(c), jnp.asarray(G * 0 + _densify(rows, cols, vals, G)),
        jnp.asarray(h), cfg,
    )
    assert np.array_equal(status, np.asarray(res_d.status))


def test_device_sparse_generator_matches_host_construction():
    rows, cols = random_sparse_inequality_lps(1, 16, 16, 0.2, seed=1)[1:3]
    c, vals, h = device_sparse_inequality_lps(
        jax.random.PRNGKey(0), 4, rows, cols, 16, 16
    )
    assert c.shape == (4, 16) and h.shape == (4, 16)
    assert vals.shape[0] == 4 and vals.shape[1] == rows.shape[0]
    # feasibility by construction: G x0 + slack = h admits x0 interior;
    # solve a lane with HiGHS to confirm bounded-feasible
    G = np.zeros((16, 16), np.float32)
    G[np.asarray(rows), np.asarray(cols)] = np.asarray(vals[0])
    ref = scipy_opt.linprog(
        np.asarray(c[0]), A_ub=G, b_ub=np.asarray(h[0]),
        bounds=(0, None), method="highs",
    )
    assert ref.status == 0


def test_ruiz_handles_empty_rows_and_columns():
    """ADVICE r4: a pattern with an empty row/column made segment_max
    return -inf, clamped to 1e-12 -- the scale then grew ~1e6x per Ruiz
    iteration and overflowed f32.  Empty segments must stay unscaled."""
    from linprog_tpu.ipm_sparse import _ruiz_sparse

    m = n = 6
    # rows 0/5 and columns 0/5 have no nonzeros
    rows = np.array([1, 2, 3, 4], np.int32)
    cols = np.array([2, 1, 4, 3], np.int32)
    vals = jnp.asarray(np.array([[2.0, 0.5, 8.0, 1.0]], np.float32))
    c = jnp.ones((1, n), jnp.float32)
    h = jnp.ones((1, m), jnp.float32)
    vals_s, c_s, h_s, r, cl = _ruiz_sparse(
        jnp.asarray(rows), jnp.asarray(cols), vals, c, h, m, n
    )
    assert np.all(np.isfinite(np.asarray(r)))
    assert np.all(np.isfinite(np.asarray(cl)))
    # empty segments keep scale 1; live entries are equilibrated to ~1
    assert np.asarray(r)[0, 0] == pytest.approx(1.0)
    assert np.asarray(cl)[0, 5] == pytest.approx(1.0)
    assert np.allclose(np.abs(np.asarray(vals_s)), 1.0, atol=1e-3)


def test_sparse_straggler_recovery_repairs_every_lane():
    """VERDICT r4 item 4: starve the sparse IPM so every lane is a
    straggler, then recover_stragglers_sparse must densify the bucket,
    route it through the pooled dense crossover, and return exact
    vertices matching HiGHS on every lane."""
    from scipy.optimize import linprog as slp

    from linprog_tpu.ipm_sparse import recover_stragglers_sparse

    Bs, m, n = 8, 24, 24
    c, rows, cols, vals, h = random_sparse_inequality_lps(
        Bs, m, n, density=0.3, seed=9
    )
    cj, vj, hj = jnp.asarray(c), jnp.asarray(vals), jnp.asarray(h)
    cfg = IPMConfig(eps_rel=1e-3, maxiters=4)  # starved
    res = ipm_solve_batch_sparse_canonical(
        cj, rows, cols, vj, hj, (m, n), cfg
    )
    assert int((np.asarray(res.status) == stt.OPTIMAL).sum()) < Bs
    rec = recover_stragglers_sparse(cj, rows, cols, vj, hj, (m, n), res)
    assert np.all(np.asarray(rec.status) == stt.OPTIMAL)
    # recovered lanes carry a real basis certificate
    assert np.all(np.asarray(rec.basis) >= 0)
    Gd = np.zeros((Bs, m, n), np.float32)
    Gd[:, np.asarray(rows), np.asarray(cols)] = vals
    for i in range(Bs):
        ref = slp(c[i], A_ub=Gd[i], b_ub=h[i], bounds=(0, None),
                  method="highs")
        if ref.status == 0:
            gap = abs(float(rec.cost[i]) - ref.fun) / max(1, abs(ref.fun))
            assert gap < 2e-5, (i, gap)


def test_sparse_auto_router_families_and_answers():
    """The sparse driver entry point (VERDICT r4 item 4): family flips on
    accuracy/size, and the IPM path's recovery backstop delivers every
    lane."""
    from scipy.optimize import linprog as slp

    from linprog_tpu.router import choose_family_sparse, solve_batch_auto_sparse

    # routing rule: memory-bound huge m -> pdhg; loose + ultra-sparse ->
    # pdhg; benched regime -> ipm
    assert choose_family_sparse(2048, 2048, 41943, 1e-3, lanes=128) == "ipm"
    assert choose_family_sparse(65536, 65536, 400000, 1e-3, lanes=8) == "pdhg"
    assert choose_family_sparse(4096, 4096, 16384, 1e-2, lanes=1) == "pdhg"

    Bs, m, n = 6, 20, 20
    c, rows, cols, vals, h = random_sparse_inequality_lps(
        Bs, m, n, density=0.3, seed=4
    )
    cj, vj, hj = jnp.asarray(c), jnp.asarray(vals), jnp.asarray(h)
    res, info = solve_batch_auto_sparse(cj, rows, cols, vj, hj, (m, n),
                                        accuracy=1e-3)
    assert info["family"] == "sparse-ipm"
    assert info.get("recovered")
    assert np.all(np.asarray(res.status) == stt.OPTIMAL)
    assert res.x.shape == (Bs, n)  # structural columns only
    Gd = np.zeros((Bs, m, n), np.float32)
    Gd[:, np.asarray(rows), np.asarray(cols)] = vals
    for i in range(Bs):
        ref = slp(c[i], A_ub=Gd[i], b_ub=h[i], bounds=(0, None),
                  method="highs")
        if ref.status == 0:
            gap = abs(float(res.cost[i]) - ref.fun) / max(1, abs(ref.fun))
            # raw-OPTIMAL lanes answer at the requested eps class (1e-3);
            # only stragglers are crossed to exact vertices
            assert gap < 2e-3, (i, gap)

    # prefer override reaches the first-order family on the same batch
    res_p, info_p = solve_batch_auto_sparse(
        cj, rows, cols, vj, hj, (m, n), accuracy=1e-3, prefer="pdhg",
        maxiters=40_000,
    )
    assert info_p["family"] == "sparse-pdhg"
    ok = np.asarray(res_p.status) == stt.OPTIMAL
    assert ok.sum() >= Bs - 1


def test_cumsum_assembly_matches_segment_assembly():
    """VERDICT r4 item 8: the prefix-sum normal assembly (scatter ->
    two gathers) must agree with the segment-sum path and solve to the
    same optima."""
    Bs, m, n = 6, 32, 32
    c, rows, cols, vals, h = random_sparse_inequality_lps(
        Bs, m, n, density=0.25, seed=2
    )
    cj, vj, hj = jnp.asarray(c), jnp.asarray(vals), jnp.asarray(h)
    cfg = IPMConfig(eps_rel=1e-3, maxiters=40)
    seg = ipm_solve_batch_sparse_canonical(cj, rows, cols, vj, hj, (m, n),
                                           cfg, assembly="segment")
    cum = ipm_solve_batch_sparse_canonical(cj, rows, cols, vj, hj, (m, n),
                                           cfg, assembly="cumsum")
    assert np.all(np.asarray(cum.status) == np.asarray(seg.status))
    np.testing.assert_allclose(np.asarray(cum.cost), np.asarray(seg.cost),
                               rtol=2e-3, atol=2e-3)
    # unit check: the assembled normal matrices themselves agree
    from linprog_tpu.ipm_sparse import SparsePattern, _SparseSlackOp

    pat = SparsePattern(rows, cols, m, n)
    pat_dev = {
        "row_cols": jnp.asarray(pat.row_cols),
        "row_slot": jnp.asarray(pat.row_slot),
        "row_mask": jnp.asarray(pat.row_mask),
        "col_rows": jnp.asarray(pat.col_rows),
        "col_slot": jnp.asarray(pat.col_slot),
        "col_mask": jnp.asarray(pat.col_mask),
        "pair_perm": jnp.asarray(pat.pair_perm),
        "pair_ids": jnp.asarray(pat.pair_ids),
    }
    d = jnp.asarray(
        np.random.default_rng(0).uniform(0.1, 3.0, (Bs, n + m)), jnp.float32
    )
    N_seg = _SparseSlackOp(pat_dev, vj, m, n).normal(d)
    starts, ends = pat.seg_bounds()
    pat_dev2 = dict(pat_dev, seg_starts=jnp.asarray(starts),
                    seg_ends=jnp.asarray(ends))
    N_cum = _SparseSlackOp(pat_dev2, vj, m, n).normal(d)
    np.testing.assert_allclose(np.asarray(N_cum), np.asarray(N_seg),
                               rtol=1e-4, atol=1e-4)
