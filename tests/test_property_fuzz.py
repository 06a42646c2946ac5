"""Property-based fuzzing against the HiGHS oracle.

Three instance families with known ground truth:
* feasible-bounded by construction -> objective must match HiGHS;
* infeasible by construction (a row with nonpositive coefficients and a
  positive rhs) -> PRIMAL_INFEASIBLE, and HiGHS agrees (status 2);
* unbounded by construction (a nonnegative recession direction with
  negative cost) -> PRIMAL_UNBOUNDED, and HiGHS agrees (status 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from linprog_tpu import SolverConfig
from linprog_tpu import status as st
from linprog_tpu.batch import solve_batch_two_phase
from linprog_tpu.generators import random_inequality_lps, to_standard_form_batch

scipy_opt = pytest.importorskip("scipy.optimize")

CFG = SolverConfig(pricing="dantzig", refactor_every=40)


@pytest.mark.parametrize("m,n,seed", [(6, 9, 0), (12, 18, 1), (20, 30, 2),
                                      (9, 40, 3), (30, 35, 4)])
def test_feasible_bounded_matches_highs(m, n, seed):
    B = 8
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    cs, As, bs = to_standard_form_batch(c, G, h)
    res = solve_batch_two_phase(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), 800, 800, CFG
    )
    assert (np.asarray(res.status) == st.OPTIMAL).all()
    for i in range(B):
        ref = scipy_opt.linprog(
            c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None), method="highs"
        )
        assert ref.status == 0
        assert abs(float(res.cost[i]) - ref.fun) / max(1, abs(ref.fun)) < 2e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_constructed_infeasible_detected(seed):
    rng = np.random.default_rng(seed)
    m, n = 8, 12
    G = rng.normal(size=(m, n)).astype(np.float32)
    h = (G @ rng.uniform(0, 1, n) + rng.uniform(0.1, 1, m)).astype(np.float32)
    # poison row: |g|'x <= -1 is impossible for x >= 0 (lhs nonnegative)
    G[0] = np.abs(G[0])
    h[0] = -1.0
    c = rng.normal(size=(1, n)).astype(np.float32)
    cs, As, bs = to_standard_form_batch(c, G[None], h[None])
    res = solve_batch_two_phase(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), 400, 400, CFG
    )
    assert int(np.asarray(res.status)[0]) == st.PRIMAL_INFEASIBLE
    ref = scipy_opt.linprog(
        np.zeros(n), A_ub=G, b_ub=h, bounds=(0, None), method="highs"
    )
    assert ref.status == 2  # HiGHS agrees: infeasible


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_constructed_unbounded_detected(seed):
    rng = np.random.default_rng(seed)
    m, n = 8, 12
    G = rng.normal(size=(m, n)).astype(np.float32)
    h = (np.abs(G @ rng.uniform(0, 1, n)) + 1.0).astype(np.float32)  # feasible at 0
    c = rng.uniform(0.1, 1.0, n).astype(np.float32)
    # recession direction e_0: make column 0 nonpositive in G and c_0 < 0
    G[:, 0] = -np.abs(G[:, 0])
    c[0] = -1.0
    cs, As, bs = to_standard_form_batch(c[None], G[None], h[None])
    res = solve_batch_two_phase(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), 400, 400, CFG
    )
    assert int(np.asarray(res.status)[0]) == st.PRIMAL_UNBOUNDED
    ref = scipy_opt.linprog(c, A_ub=G, b_ub=h, bounds=(0, None), method="highs")
    assert ref.status == 3  # HiGHS agrees: unbounded


def test_mixed_status_batch():
    """One batch containing optimal, infeasible, and unbounded lanes."""
    rng = np.random.default_rng(9)
    m, n = 6, 8
    c, G, h = random_inequality_lps(3, m, n, seed=9)
    G = G.copy()
    h = h.copy()
    c = c.copy()
    # lane 1 -> infeasible: |g|'x <= -1
    G[1, 0] = np.abs(G[1, 0])
    h[1, 0] = -1.0
    # lane 2 -> unbounded via recession direction e_0
    G[2, :, 0] = -np.abs(G[2, :, 0])
    h[2] = np.abs(h[2]) + 1.0
    c[2, 0] = -1.0
    cs, As, bs = to_standard_form_batch(c, G, h)
    res = solve_batch_two_phase(
        jnp.asarray(cs), jnp.asarray(As), jnp.asarray(bs), 300, 300, CFG
    )
    status = np.asarray(res.status)
    assert status[0] == st.OPTIMAL
    assert status[1] == st.PRIMAL_INFEASIBLE
    assert status[2] == st.PRIMAL_UNBOUNDED


def test_farkas_certificates_on_infeasible_lanes():
    """PRIMAL_INFEASIBLE lanes report a verifiable Farkas ray in `y`:
    y'A <= tol componentwise and y'b > 0 prove infeasibility."""
    import jax.numpy as jnp

    from linprog_tpu.batch import solve_batch_two_phase

    rng = np.random.default_rng(17)
    B, m, n = 6, 8, 10
    feas_c, feas_G, feas_h = random_inequality_lps(B, m, n, seed=17)
    cs, As, bs = to_standard_form_batch(feas_c, feas_G, feas_h)
    As = np.asarray(As).copy()
    bs = np.asarray(bs).copy()
    # make lanes 1, 3 infeasible: two contradictory equality rows
    for lane in (1, 3):
        As[lane, 0, :] = 0.0
        As[lane, 1, :] = 0.0
        As[lane, 0, 0] = 1.0
        As[lane, 1, 0] = 1.0
        bs[lane, 0] = 1.0
        bs[lane, 1] = 2.0  # x0 = 1 AND x0 = 2
    res = solve_batch_two_phase(jnp.asarray(cs), jnp.asarray(As),
                                jnp.asarray(bs), 300, 300)
    status = np.asarray(res.status)
    assert (status[[1, 3]] == st.PRIMAL_INFEASIBLE).all()
    assert (status[[0, 2, 4, 5]] == st.OPTIMAL).all()
    y = np.asarray(res.y)
    for lane in (1, 3):
        ray = y[lane]
        assert (ray @ As[lane] <= 1e-5).all(), lane
        assert ray @ bs[lane] > 1e-6, lane


def test_farkas_certificate_on_single_api_path():
    from linprog_tpu import SimplexSolver
    from linprog_tpu.status import PrimalIsInfeasibleError

    c = np.array([1.0])
    A = np.array([[1.0], [1.0]])
    b = np.array([1.0, 2.0])
    with pytest.raises(PrimalIsInfeasibleError) as ei:
        SimplexSolver(c, A=A, b=b).solve()
    ray = getattr(ei.value, "certificate", None)
    assert ray is not None
    # certificate lives in the Phase-I (standard-form + bound-rows) space;
    # the constraint block there starts with the original rows
    m = b.shape[0]
    assert ray[:m] @ b > 1e-8


def test_unbounded_ray_certificates():
    """PRIMAL_UNBOUNDED lanes yield a verifiable improving ray:
    A d = 0, d >= 0, c'd < 0; other lanes return the zero vector."""
    import jax.numpy as jnp

    from linprog_tpu.batch import (
        solve_batch_two_phase,
        unbounded_rays_from_result,
    )

    feas_c, feas_G, feas_h = random_inequality_lps(4, 6, 8, seed=23)
    cs, As, bs = to_standard_form_batch(feas_c, feas_G, feas_h)
    cs = np.asarray(cs).copy()
    As = np.asarray(As).copy()
    bs = np.asarray(bs).copy()
    # lane 2: make the first two structural columns an unbounded direction
    # x0 = x1 -> A (e0 + e1) = 0 with cost c0 + c1 < 0
    As[2, :, 0] = -As[2, :, 1]
    cs[2, 0] = -1.0
    cs[2, 1] = -1.0
    res = solve_batch_two_phase(jnp.asarray(cs), jnp.asarray(As),
                                jnp.asarray(bs), 300, 300)
    status = np.asarray(res.status)
    assert status[2] == st.PRIMAL_UNBOUNDED
    rays = np.asarray(unbounded_rays_from_result(
        jnp.asarray(cs), jnp.asarray(As), res))
    for lane in range(4):
        if lane == 2:
            d = rays[2]
            assert (d >= 0).all()
            assert np.abs(As[2] @ d).max() < 1e-4
            assert cs[2] @ d < -1e-6
        else:
            assert (rays[lane] == 0).all(), lane


def test_ill_conditioned_instances_never_silently_wrong():
    """Severely ill-conditioned LPs must either solve to the oracle's
    optimum or report a non-OPTIMAL status -- never a silent wrong
    OPTIMAL (the failure-detection surface, SURVEY section 5)."""
    import jax.numpy as jnp

    from scipy.optimize import linprog as highs

    from linprog_tpu.batch import solve_batch_two_phase
    from linprog_tpu.config import SolverConfig

    rng = np.random.default_rng(31)
    B, m, n = 6, 12, 16
    c, G, h = random_inequality_lps(B, m, n, seed=31)
    G = np.asarray(G, np.float64).copy()
    # grade row scales over 6 orders of magnitude: cond(B) ~ 1e6+
    scales = np.logspace(-3, 3, m)
    G *= scales[None, :, None]
    h = np.asarray(h, np.float64) * scales[None, :]
    cs = np.concatenate([c, np.zeros((B, m), np.float32)], axis=1)
    As = np.concatenate(
        [G.astype(np.float32),
         np.broadcast_to(np.eye(m, dtype=np.float32), (B, m, m))], axis=2
    )
    bs = h.astype(np.float32)
    # f32 path with polish: the realistic device configuration
    cfg = SolverConfig(pricing="dantzig", refactor_every=64,
                       polish_pivots=8)
    res = solve_batch_two_phase(jnp.asarray(cs), jnp.asarray(As),
                                jnp.asarray(bs), 600, 600, cfg)
    status = np.asarray(res.status)
    costs = np.asarray(res.cost)
    checked = 0
    for i in range(B):
        ref = highs(c[i], A_ub=G[i], b_ub=h[i], bounds=(0, None),
                    method="highs")
        if ref.status != 0:
            continue
        if status[i] == st.OPTIMAL:
            gap = abs(costs[i] - ref.fun) / max(1.0, abs(ref.fun))
            assert gap < 5e-3, (i, gap)  # coarse: f32 at cond ~1e6
            checked += 1
    assert checked >= 3  # most lanes should still solve
