"""Oracle-free vertex certification (linprog_tpu.certify).

VERDICT r4 item 2: at m=4096 there is no affordable HiGHS oracle, so the
exact pipeline must self-certify -- per-lane dd-accuracy KKT residuals
from the returned BASIS.  These tests pin the certificate against the
HiGHS oracle at oracle-able sizes: certified lanes must be true optima,
and corrupted bases must FAIL certification loudly.
"""

import numpy as np
import pytest

scipy_opt = pytest.importorskip("scipy.optimize")

import jax.numpy as jnp

from linprog_tpu.certify import certificate_summary, certify_vertex_batch
from linprog_tpu.config import SolverConfig
from linprog_tpu.generators import random_inequality_lps
from linprog_tpu.router import solve_batch_exact

B, M, N = 12, 20, 20
CFG = SolverConfig(pricing="dantzig", refactor_every=64,
                   polish_pivots=8)


@pytest.fixture(scope="module")
def exact_solved():
    c, G, h = random_inequality_lps(B, M, N, seed=21)
    c, G, h = jnp.asarray(c), jnp.asarray(G), jnp.asarray(h)
    res, info = solve_batch_exact(c, G, h, cfg=CFG, maxiters=400)
    return c, G, h, res, info


def test_certified_lanes_match_highs(exact_solved):
    c, G, h, res, info = exact_solved
    cert = certify_vertex_batch(c, G, h, res.basis)
    ok = np.asarray(cert["certified"])
    assert ok.sum() >= B - 1  # the exact pipeline should certify ~all
    cn, Gn, hn = np.asarray(c), np.asarray(G), np.asarray(h)
    for i in np.flatnonzero(ok):
        ref = scipy_opt.linprog(cn[i], A_ub=Gn[i], b_ub=hn[i],
                                bounds=(0, None), method="highs")
        assert ref.status == 0
        gap = abs(float(res.cost[i]) - ref.fun) / max(1.0, abs(ref.fun))
        assert gap < 1e-5, (i, gap)


def test_certificate_residuals_are_dd_class(exact_solved):
    """The whole point vs an f32 check: the reported residuals must sit
    well below the f32 pricing floor (~5e-4) on truly-optimal lanes."""
    c, G, h, res, _ = exact_solved
    cert = certify_vertex_batch(c, G, h, res.basis)
    ok = np.asarray(cert["certified"])
    pr = np.asarray(cert["primal_residual"])[ok]
    gap = np.asarray(cert["gap"])[ok]
    assert pr.max() < 1e-6
    # the residual-identity gap floor is ~eps * ||xB|| * ||rc_B|| -- a
    # couple of e-6 worst-lane, still ~100x below the f32 pricing floor
    assert gap.max() < 5e-6


def test_corrupted_basis_fails_certification(exact_solved):
    """Swap one basic column for a non-basic one: primal feasibility or
    dual feasibility must break at a scale the certificate cannot miss."""
    c, G, h, res, _ = exact_solved
    basis = np.asarray(res.basis).copy()
    for i in range(B):
        present = set(basis[i].tolist())
        for j in range(N + M):
            if j not in present:
                basis[i, 0] = j
                break
    cert = certify_vertex_batch(c, G, h, jnp.asarray(basis))
    ok = np.asarray(cert["certified"])
    assert ok.sum() <= 1  # a swapped column is (almost) never optimal


def test_certificate_summary_shape(exact_solved):
    c, G, h, res, _ = exact_solved
    s = certificate_summary(certify_vertex_batch(c, G, h, res.basis))
    assert s["lanes"] == B
    assert s["certified"] >= B - 1
    assert s["max_primal_residual"] < 1e-6
    assert s["max_gap"] < 5e-6
