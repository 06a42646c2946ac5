"""Structured-instance acceptance suite (netlib-style validation).

Each instance is round-tripped through the MPS writer + native C++ reader,
solved with the general-form SimplexSolver, and the objective checked
against the SciPy HiGHS (f64) oracle to 1e-5 relative -- the committed
stand-in for the netlib set, which a zero-egress sandbox cannot download
(documented in PARITY.md).  These families are sparse/degenerate/uneven-
scaled, unlike the iid-gaussian bench distribution.
"""

import numpy as np
import pytest

scipy_opt = pytest.importorskip("scipy.optimize")

from linprog_tpu import SimplexSolver, SolverConfig
from linprog_tpu.io import mps_to_solver_inputs, read_mps
from linprog_tpu.io.write_mps import write_mps
from linprog_tpu.structured import default_suite

SUITE = default_suite()


def _highs_solve(p):
    n = p["c"].shape[0]
    lb = np.zeros(n) if p["lb"] is None else np.asarray(p["lb"], np.float64)
    ub = np.full(n, np.inf) if p["ub"] is None else np.asarray(
        p["ub"], np.float64
    )
    ref = scipy_opt.linprog(
        p["c"],
        A_eq=p["A"], b_eq=p["b"], A_ub=p["G"], b_ub=p["h"],
        bounds=list(zip(
            [None if np.isneginf(v) else v for v in lb],
            [None if np.isposinf(v) else v for v in ub],
        )),
        method="highs",
    )
    return ref


@pytest.mark.parametrize("p", SUITE, ids=[p["name"] for p in SUITE])
def test_structured_instance_via_mps_roundtrip(p, tmp_path):
    path = str(tmp_path / (p["name"] + ".mps"))
    write_mps(path, p["c"], A=p["A"], b=p["b"], G=p["G"], h=p["h"],
              lb=p["lb"], ub=p["ub"], name=p["name"])
    prob = read_mps(path)
    c, A, b, G, h, lb, ub = mps_to_solver_inputs(prob)

    # round-trip integrity: objective vector and total constraint mass
    np.testing.assert_allclose(c, p["c"], rtol=1e-9)
    mass = (0 if p["A"] is None else np.abs(p["A"]).sum()) + (
        0 if p["G"] is None else np.abs(p["G"]).sum()
    )
    mass_rt = (0 if A is None else np.abs(A).sum()) + (
        0 if G is None else np.abs(G).sum()
    )
    assert mass_rt == pytest.approx(mass, rel=1e-9)

    ref = _highs_solve(p)
    assert ref.status == 0, f"oracle failed on {p['name']}"

    cfg = SolverConfig(pricing="dantzig", refactor_every=64)
    res = SimplexSolver(c, A=A, b=b, G=G, h=h, lb=lb, ub=ub,
                        config=cfg).solve(maxiters1=3000, maxiters2=3000)
    assert res.optimum, f"{p['name']}: not optimal (iters={res.iters})"
    gap = abs(res.cost - ref.fun) / max(1.0, abs(ref.fun))
    assert gap < 1e-5, f"{p['name']}: gap {gap:.2e} vs HiGHS {ref.fun}"


def test_suite_has_degenerate_and_redundant_instances():
    names = [p["name"] for p in SUITE]
    assert len(SUITE) >= 12
    assert any("assign" in s for s in names)  # maximal degeneracy
    assert any("transp" in s for s in names)  # redundant balance row
    assert any("cheb" in s for s in names)  # uneven scaling + free vars


def test_devex_vs_dantzig_pivot_counts_on_structured_suite():
    """Records the devex-vs-dantzig pivot comparison the config docstring
    cites (VERDICT r3 item 8): real reference-weight devex on the XLA
    batched path reaches the same optima; on these structured families it
    measured ~= dantzig in total pivots (historically within a few %,
    which is why dantzig stays the tuned default).  The assertion pins the
    sane band, not an exact count."""
    from linprog_tpu.batch import solve_batch_general

    probs = [
        {k: p[k] for k in ("c", "A", "b", "G", "h") if p.get(k) is not None}
        for p in SUITE
        if p["lb"] is None and p["ub"] is None
    ][:6]
    assert len(probs) >= 4
    totals = {}
    for rule in ("dantzig", "devex"):
        cfg = SolverConfig(pricing=rule, refactor_every=128,
                           polish_pivots=0)
        res = solve_batch_general(probs, 3000, 3000, cfg)
        assert all(r.optimum for r in res), rule
        totals[rule] = sum(r.iters for r in res)
    ratio = totals["devex"] / max(1, totals["dantzig"])
    # devex must be in the same class as dantzig on these families
    assert 0.4 < ratio < 2.0, totals
