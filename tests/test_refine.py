"""Double-word terminal polish (linprog_tpu.refine).

The dd primitives must beat plain-f32 accuracy by orders of magnitude, and
the polished batched solve must close the f32 objective gap vs the HiGHS
f64 oracle (the 1e-6-relative target; the reference's own tolerance is a
loose 1e-2, ``/root/reference/tests/constants.py:1``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linprog_tpu import SolverConfig
from linprog_tpu import status as st
from linprog_tpu.batch import batch_summary, solve_batch_two_phase
from linprog_tpu.generators import random_inequality_lps, to_standard_form_batch
from linprog_tpu.refine import dd_dot, dd_rowmat, refine_duals


def test_dd_rowmat_beats_f32():
    rng = np.random.default_rng(0)
    B, m, n = 4, 257, 64  # odd m exercises the chunk padding
    y64 = rng.standard_normal((B, m))
    M64 = rng.standard_normal((B, m, n))
    exact = np.einsum("bm,bmn->bn", y64, M64)

    y32 = jnp.asarray(y64, jnp.float32)
    M32 = jnp.asarray(M64, jnp.float32)
    plain = np.asarray(
        jnp.einsum("bm,bmn->bn", y32, M32), np.float64
    )
    dd = np.asarray(dd_rowmat(y32, M32), np.float64)

    # compare against the f64 product of the F32-ROUNDED inputs (that is
    # what dd can possibly recover)
    exact32 = np.einsum(
        "bm,bmn->bn", np.asarray(y32, np.float64), np.asarray(M32, np.float64)
    )
    scale = np.abs(y64) @ np.abs(M64)
    err_plain = np.max(np.abs(plain - exact32) / scale)
    err_dd = np.max(np.abs(dd - exact32) / scale)
    # CPU XLA's f32 einsum uses pairwise accumulation and is already near
    # eps (with reduced-precision matmuls the plain path is far worse); dd
    # must still not lose to it and must sit at the ~eps floor rather than
    # eps*sqrt(m)
    assert err_dd <= err_plain
    assert err_dd < 5e-8
    del exact


def test_dd_dot():
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal((3, 300)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((3, 300)), jnp.float32)
    exact = np.einsum(
        "bm,bm->b", np.asarray(u, np.float64), np.asarray(v, np.float64)
    )
    got = np.asarray(dd_dot(u, v), np.float64)
    scale = np.einsum("bm,bm->b", np.abs(np.asarray(u)), np.abs(np.asarray(v)))
    assert np.max(np.abs(got - exact) / scale) < 5e-8


def test_refine_duals_converges():
    rng = np.random.default_rng(2)
    B, m = 3, 64
    Bmat64 = rng.standard_normal((B, m, m)) + 3 * np.eye(m)
    cB64 = rng.standard_normal((B, m))
    y_exact = np.stack(
        [np.linalg.solve(Bmat64[i].T, cB64[i]) for i in range(B)]
    )
    Bmat = jnp.asarray(Bmat64, jnp.float32)
    cB = jnp.asarray(cB64, jnp.float32)
    inv_B = jnp.linalg.inv(Bmat)
    y0 = np.asarray(jnp.einsum("bm,bmk->bk", cB, inv_B), np.float64)
    y2 = np.asarray(refine_duals(cB, Bmat, inv_B, steps=2), np.float64)
    # compare vs the f64 solve of the f32-rounded system
    y_exact32 = np.stack([
        np.linalg.solve(np.asarray(Bmat[i], np.float64).T,
                        np.asarray(cB[i], np.float64))
        for i in range(B)
    ])
    e0 = np.max(np.abs(y0 - y_exact32)) / np.max(np.abs(y_exact32))
    e2 = np.max(np.abs(y2 - y_exact32)) / np.max(np.abs(y_exact32))
    assert e2 < e0 / 4
    # floor: dd residual accuracy is ~eps * (|y||B| mass), a few e-6 here
    assert e2 < 5e-6
    del y_exact


def test_polished_two_phase_closes_f32_gap():
    scipy_opt = pytest.importorskip("scipy.optimize")
    B, m, n = 24, 48, 64
    c, G, h = random_inequality_lps(B, m, n, seed=11)
    cs, As, bs = to_standard_form_batch(c, G, h)
    cs = jnp.asarray(cs, jnp.float32)
    As = jnp.asarray(As, jnp.float32)
    bs = jnp.asarray(bs, jnp.float32)

    base_cfg = SolverConfig(pricing="dantzig", refactor_every=64)
    res0 = solve_batch_two_phase(cs, As, bs, 800, 800, base_cfg)
    res1 = solve_batch_two_phase(
        cs, As, bs, 800, 800, base_cfg.replace(polish_pivots=16)
    )
    assert batch_summary(res1)["optimal"] == B

    gaps0, gaps1 = [], []
    for i in range(B):
        ref = scipy_opt.linprog(
            np.asarray(c[i], np.float64), A_ub=np.asarray(G[i], np.float64),
            b_ub=np.asarray(h[i], np.float64), bounds=(0, None),
            method="highs",
        )
        assert ref.status == 0
        den = max(1.0, abs(ref.fun))
        gaps0.append(abs(float(res0.cost[i]) - ref.fun) / den)
        gaps1.append(abs(float(res1.cost[i]) - ref.fun) / den)
    # polished must meet the 1e-5 bar and not be worse than unpolished
    assert max(gaps1) < 1e-5, (max(gaps0), max(gaps1))
    assert max(gaps1) <= max(gaps0) * 1.5 + 1e-7


def test_polish_noop_when_disabled_or_infeasible():
    # an infeasible lane must pass through the polish path untouched
    c = jnp.asarray([[1.0, 1.0, 0.0]], jnp.float32)
    A = jnp.asarray([[[1.0, 1.0, 0.0], [1.0, 1.0, 1.0]]], jnp.float32)
    b = jnp.asarray([[2.0, 1.0]], jnp.float32)  # x1+x2=2 but x1+x2+x3=1
    cfg = SolverConfig(polish_pivots=8)
    res = solve_batch_two_phase(c, A, b, 100, 100, cfg)
    assert int(np.asarray(res.status)[0]) == st.PRIMAL_INFEASIBLE
