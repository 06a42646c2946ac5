"""The batched XLA simplex loop, two-phase pipeline and IPM factor.

These pin the behaviours the batched paths must keep: parity with the
vmapped per-lane engine, the pricing rules across refactor segments, the
iteration cap, two-phase answers (optimal, infeasible and unbounded lanes)
against HiGHS, and the all-matmul Cholesky inverse against NumPy.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linprog

from linprog_tpu import SolverConfig, engine
from linprog_tpu import status as st
from linprog_tpu.batch import solve_batch_two_phase
from linprog_tpu.config import FAST_CONFIG
from linprog_tpu.engine_batched import run_batched
from linprog_tpu.generators import random_inequality_lps, to_standard_form_batch
from linprog_tpu.ipm import block_cholesky_inverse


def _phase1_setup(B=6, m=8, n=10, seed=0):
    """Phase-I problem (artificial start) of a random feasible batch."""
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    cs, As, bs = to_standard_form_batch(c, G, h)
    bsj = jnp.asarray(bs)
    ntot = cs.shape[1]
    c1 = jnp.concatenate(
        [jnp.zeros((B, ntot), jnp.float32), jnp.ones((B, m), jnp.float32)],
        axis=1,
    )
    eye = jnp.broadcast_to(jnp.eye(m, dtype=jnp.float32), (B, m, m))
    A1 = jnp.concatenate([jnp.asarray(As), eye], axis=2)
    states = jax.vmap(engine.artificial_state, in_axes=(0, None))(bsj, ntot)
    allowed = jnp.ones((ntot + m,), bool)
    return c1, A1, bsj, states, allowed


@pytest.mark.parametrize("seed", [0, 4, 9])
@pytest.mark.parametrize("pricing", ["bland", "dantzig"])
def test_run_batched_matches_vmapped_engine(pricing, seed):
    """Whole solves: same statuses, pivots and bases as the per-lane engine."""
    cfg = SolverConfig(pricing=pricing, refactor_every=0, stall_limit=0)
    c1, A1, bsj, states, allowed = _phase1_setup(seed=seed)
    ref = jax.vmap(
        engine.run, in_axes=(0, 0, 0, 0, None, None, None, None)
    )(c1, A1, bsj, states, allowed, 100, cfg, "primal")
    out = run_batched(c1, A1, bsj, states, allowed, 100, cfg)
    assert np.array_equal(np.asarray(out.status), np.asarray(ref.status))
    assert np.array_equal(np.asarray(out.iters), np.asarray(ref.iters))
    assert np.array_equal(np.asarray(out.basis), np.asarray(ref.basis))
    np.testing.assert_allclose(
        np.asarray(out.bfs), np.asarray(ref.bfs), atol=2e-4, rtol=2e-4
    )


@pytest.mark.parametrize("refactor_every", [3, 16])
@pytest.mark.parametrize("pricing", ["bland", "dantzig", "devex"])
def test_run_batched_refactor_segments(pricing, refactor_every):
    """Every pricing rule across refactor segments drives Phase I of a
    feasible batch to zero artificial mass."""
    cfg = SolverConfig(pricing=pricing, refactor_every=refactor_every)
    c1, A1, bsj, states, allowed = _phase1_setup(seed=7)
    out = run_batched(c1, A1, bsj, states, allowed, 100, cfg)
    assert (np.asarray(out.status) == st.OPTIMAL).all()
    n_struct = c1.shape[1] - bsj.shape[1]
    art = np.asarray(out.basis) >= n_struct
    art_mass = np.where(art, np.asarray(out.bfs), 0.0).sum(axis=1)
    assert (art_mass < 1e-4).all()


@pytest.mark.parametrize("maxiters", [1, 2, 5])
def test_run_batched_respects_maxiters(maxiters):
    cfg = SolverConfig(pricing="dantzig", refactor_every=2)
    c1, A1, bsj, states, allowed = _phase1_setup(seed=1)
    out = run_batched(c1, A1, bsj, states, allowed, maxiters, cfg)
    iters = np.asarray(out.iters)
    assert (iters <= maxiters).all()
    running = np.asarray(out.status) == st.RUNNING
    assert (iters[running] == maxiters).all()


def _highs_canonical(c, G, h):
    return [
        linprog(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None), method="highs")
        for i in range(c.shape[0])
    ]


@pytest.mark.parametrize("cfg", [
    SolverConfig(pricing="bland"),
    SolverConfig(pricing="dantzig", refactor_every=16),
    SolverConfig(pricing="devex", refactor_every=16),
    FAST_CONFIG,
], ids=["bland", "dantzig-seg16", "devex-seg16", "fast"])
def test_two_phase_matches_highs(cfg):
    B, m, n = 8, 10, 14
    c, G, h = random_inequality_lps(B, m, n, seed=9)
    cs, As, bs = to_standard_form_batch(c, G, h)
    res = solve_batch_two_phase(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), 300, 300, cfg
    )
    assert (np.asarray(res.status) == st.OPTIMAL).all()
    for i, ref in enumerate(_highs_canonical(c, G, h)):
        assert ref.status == 0
        gap = abs(float(res.cost[i]) - ref.fun) / max(1.0, abs(ref.fun))
        assert gap < 5e-5, (i, gap)


@pytest.mark.parametrize("pricing", ["bland", "dantzig", "devex"])
def test_two_phase_infeasible_and_unbounded_lanes(pricing):
    """Lanes 0-1 are feasible, lane 2 is infeasible, lane 3 is unbounded:
    the batch reports each lane's own status, as HiGHS does."""
    c, G, h = random_inequality_lps(4, 6, 8, seed=5)
    G[2, 0] = np.abs(G[2, 0]) + 0.1  # row 0 of lane 2: G x >= 0.1 x_j ...
    h[2, 0] = -1.0                   # ... <= -1 with x >= 0: infeasible
    G[3, :, 0] = -np.abs(G[3, :, 0])  # column 0 only loosens every row
    c[3, 0] = -1.0                    # ... and improves the cost: unbounded
    cs, As, bs = to_standard_form_batch(c, G, h)
    res = solve_batch_two_phase(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), 300, 300,
        SolverConfig(pricing=pricing, refactor_every=8),
    )
    status = np.asarray(res.status)
    expect = {0: st.OPTIMAL, 2: st.PRIMAL_INFEASIBLE, 3: st.PRIMAL_UNBOUNDED}
    highs_code = {0: st.OPTIMAL, 2: st.PRIMAL_INFEASIBLE,
                  3: st.PRIMAL_UNBOUNDED}
    for i, ref in enumerate(_highs_canonical(c, G, h)):
        assert highs_code[ref.status] == status[i] == expect.get(
            i, st.OPTIMAL), (i, status[i], ref.status)
        if ref.status == 0:
            gap = abs(float(res.cost[i]) - ref.fun) / max(1.0, abs(ref.fun))
            assert gap < 5e-5


def _spd(B, m, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, m, m))
    return X @ np.swapaxes(X, 1, 2) + m * np.eye(m)


@pytest.mark.parametrize("m", [8, 16, 32, 33, 47, 64, 100, 128])
def test_block_cholesky_inverse_matches_numpy(m):
    """``W = L^{-1}``: W matches NumPy's inverse Cholesky factor and
    ``W'W = M^{-1}``, for block and odd sizes alike."""
    M = _spd(4, m, seed=m).astype(np.float32)
    W = np.asarray(block_cholesky_inverse(jnp.asarray(M)), np.float64)
    M64 = M.astype(np.float64)
    L = np.linalg.cholesky(M64)
    W_ref = np.linalg.inv(L)
    assert np.abs(W - W_ref).max() / np.abs(W_ref).max() < 1e-4
    Minv = np.linalg.inv(M64)
    WtW = np.einsum("bji,bjk->bik", W, W)
    assert np.abs(WtW - Minv).max() / np.abs(Minv).max() < 1e-4


@pytest.mark.parametrize("m", [16, 80])
def test_block_cholesky_inverse_non_spd_is_nonfinite(m):
    """A lane that is not positive definite comes back non-finite (as
    ``cholesky`` does), and the other lanes are untouched."""
    M = _spd(3, m, seed=1).astype(np.float32)
    M[1] = -M[1]
    W = np.asarray(block_cholesky_inverse(jnp.asarray(M)))
    assert np.isfinite(W[0]).all() and np.isfinite(W[2]).all()
    assert not np.isfinite(W[1]).all()


def test_no_module_uses_pallas():
    """The package holds no Pallas kernels and no memory-space budgets:
    every path is plain jax.numpy/lax, compiled by XLA for the device."""
    root = pathlib.Path(__file__).resolve().parents[1] / "linprog_tpu"
    pat = re.compile(r"pallas|vmem|mosaic", re.IGNORECASE)
    hits = [str(p) for p in root.rglob("*.py") if pat.search(p.read_text())]
    assert hits == []
    assert not (root / "ops").exists()
