"""Solver-family auto-router (linprog_tpu.router).

The router must (a) encode the measured regime boundaries, (b) produce
correct results through every family with a uniform result surface
(x over the structural columns), and (c) honor explicit overrides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linprog as scipy_linprog

from linprog_tpu import choose_family, solve_batch_auto, solve_batch_exact
from linprog_tpu import status as st
from linprog_tpu.config import SolverConfig
from linprog_tpu.generators import random_inequality_lps


def test_routing_rules_match_cpu_table():
    # exact accuracy: simplex small, ipm+crossover from m=256 up
    assert choose_family(128, 1e-6) == "simplex"
    assert choose_family(256, 1e-6) == "ipm+crossover"
    assert choose_family(512, 1e-6) == "ipm+crossover"
    assert choose_family(2048, 1e-6) == "ipm+crossover"
    # moderate accuracy: ipm from m ~ 256 up
    assert choose_family(128, 1e-3) == "simplex"
    assert choose_family(256, 1e-3) == "ipm"
    assert choose_family(1024, 1e-3) == "ipm"
    # huge + loose: first-order
    assert choose_family(4096, 1e-4) == "pdhg"
    assert choose_family(4096, 1e-6) == "ipm+crossover"


def _highs(c, G, h):
    return np.array([
        scipy_linprog(
            np.asarray(c[i]), A_ub=np.asarray(G[i]), b_ub=np.asarray(h[i]),
            bounds=(0, None), method="highs",
        ).fun
        for i in range(c.shape[0])
    ])


@pytest.mark.parametrize("prefer,tol", [
    ("simplex", 1e-4), ("ipm", 5e-3), ("ipm+crossover", 1e-4),
    ("pdhg", 5e-3),
])
def test_every_family_solves_correctly(prefer, tol):
    B, m, n = 6, 16, 24
    c, G, h = random_inequality_lps(B, m, n, seed=4)
    c, G, h = jnp.asarray(c), jnp.asarray(G), jnp.asarray(h)
    cfg = None
    if prefer == "simplex":
        cfg = SolverConfig(polish_pivots=4,
                           pricing="dantzig", refactor_every=128)
    res, info = solve_batch_auto(c, G, h, accuracy=1e-4, prefer=prefer,
                                 cfg=cfg)
    assert info["family"] == prefer
    assert res.x.shape == (B, n)  # uniform structural-space surface
    ref = _highs(c, G, h)
    ok = np.asarray(res.status) == st.OPTIMAL
    assert ok.sum() >= B - 1
    gaps = np.abs(np.asarray(res.cost) - ref) / np.maximum(1, np.abs(ref))
    assert gaps[ok].max() < tol


def test_auto_choice_and_summary():
    from linprog_tpu.router import auto_summary

    B, m, n = 4, 12, 18
    c, G, h = random_inequality_lps(B, m, n, seed=6)
    res, info = solve_batch_auto(
        jnp.asarray(c), jnp.asarray(G), jnp.asarray(h), accuracy=1e-6,
        cfg=SolverConfig(pricing="dantzig",
                         refactor_every=128),
    )
    assert info["family"] == "simplex"  # m=12, exact
    s = auto_summary(res, info)
    assert s["optimal"] == B
    ref = _highs(c, G, h)
    gaps = np.abs(np.asarray(res.cost) - ref) / np.maximum(1, np.abs(ref))
    assert gaps.max() < 1e-4


def test_unknown_family_rejected():
    c, G, h = random_inequality_lps(2, 4, 6, seed=1)
    with pytest.raises(ValueError):
        solve_batch_auto(jnp.asarray(c), jnp.asarray(G), jnp.asarray(h),
                         prefer="neural")


def test_solve_batch_exact_fallback_guarantees_vertices():
    """solve_batch_exact: lanes that fail to cross (forced here with a
    1-pivot crossover budget) must be repaired by the two-phase simplex
    fallback -- every OPTIMAL answer is vertex-exact."""
    from linprog_tpu import solve_batch_exact

    B, m, n = 8, 32, 32
    c, G, h = random_inequality_lps(B, m, n, seed=8)
    c, G, h = jnp.asarray(c), jnp.asarray(G), jnp.asarray(h)
    cfg = SolverConfig(pricing="dantzig", refactor_every=128,
                       polish_pivots=4)
    # polish-free 1-pivot budget with the weaker magnitude ranking: some
    # guesses stay primal-infeasible, forcing the two-phase fallback
    # (round 5: the tiny-budget trick alone stopped forcing it -- lanes
    # already optimal after round 1 are no longer reset by round 2)
    res, info = solve_batch_exact(c, G, h, cfg=cfg, maxiters=1,
                                  guess="magnitude")
    assert info["fallback"] > 0  # the tiny budget forced the fallback
    assert (np.asarray(res.status) == st.OPTIMAL).all()
    ref = _highs(c, G, h)
    gaps = np.abs(np.asarray(res.cost) - ref) / np.maximum(1, np.abs(ref))
    assert gaps.max() < 1e-4

    # and with a real budget the crossover handles (nearly) everything
    res2, info2 = solve_batch_exact(c, G, h, cfg=cfg)
    gaps2 = np.abs(np.asarray(res2.cost) - ref) / np.maximum(1, np.abs(ref))
    assert gaps2.max() < 1e-4
    assert info2["crossed"] + info2["fallback"] >= B - 1


def test_injected_calibration_table_flips_routing():
    """The routing thresholds are per-device measurements in one data file;
    an injected fake-measurement table must flip the family choice (and
    tuned_config's segment knee) without code edits."""
    from linprog_tpu import calibration
    from linprog_tpu.config import tuned_config

    base = choose_family(128, 1e-6)
    assert base == "simplex"  # cpu table: simplex up to m=192
    seg_base = tuned_config(128).refactor_every
    try:
        calibration.set_table({
            "cpu": {
                "exact_simplex_max_m": 4,
                "moderate_simplex_max_m": 4,
                "pdhg_min_m": 64,
                "exact_eps": 1e-5,
                "cleanup_tuned_seg_max_m": 512,
                "seg_by_m": [[0, 96]],
            }
        })
        assert choose_family(128, 1e-6) == "ipm+crossover"
        assert choose_family(128, 1e-3) == "pdhg"  # m >= fake pdhg_min_m
        assert tuned_config(128).refactor_every == 96
    finally:
        calibration.reset_table()
    assert choose_family(128, 1e-6) == base
    assert tuned_config(128).refactor_every == seg_base


def test_calibration_unknown_device_raises():
    """A device with no entry must not borrow another device's timings:
    the lookup raises and names the command that measures an entry."""
    from linprog_tpu import calibration
    from linprog_tpu.config import tuned_config

    with pytest.raises(calibration.UncalibratedDeviceError,
                       match="calibrate"):
        calibration.get_table("made-up-chip")
    try:
        calibration.set_table({"made-up-chip": {}})
        with pytest.raises(calibration.UncalibratedDeviceError):
            choose_family(256, 1e-6)  # the live device (cpu) has no entry
        with pytest.raises(calibration.UncalibratedDeviceError):
            tuned_config(256)
    finally:
        calibration.reset_table()


def test_calibration_partial_entry_raises():
    """An entry missing a threshold is an error naming the missing key,
    never a silent fill-in from another device's entry."""
    from linprog_tpu import calibration

    try:
        table = dict(calibration.get_table("cpu"))
        del table["pdhg_min_m"]
        calibration.set_table({"cpu": table})
        with pytest.raises(calibration.UncalibratedDeviceError,
                           match="pdhg_min_m"):
            calibration.get_table()
    finally:
        calibration.reset_table()


def test_env_override_file_is_the_only_source(tmp_path, monkeypatch):
    """LINPROG_TPU_CALIBRATION replaces the packaged file: its entries are
    read, and a device it does not list raises."""
    import json

    from linprog_tpu import calibration

    entry = dict(calibration.get_table("cpu"), exact_simplex_max_m=9)
    p = tmp_path / "override.json"
    p.write_text(json.dumps({"weird-chip": entry}))
    monkeypatch.setenv("LINPROG_TPU_CALIBRATION", str(p))
    calibration.reset_table()  # drop the cached packaged file
    try:
        t = calibration.get_table("weird-chip")
        assert t["exact_simplex_max_m"] == 9
        assert calibration.seg_for_m(256, "weird-chip") == 512
        with pytest.raises(calibration.UncalibratedDeviceError):
            calibration.get_table("cpu")
    finally:
        monkeypatch.delenv("LINPROG_TPU_CALIBRATION")
        calibration.reset_table()


def test_calibrate_measures_every_table_key():
    """Every routing key is derived from live timings (tiny sizes here --
    the values are CPU-meaningless, the MEASUREMENT coverage is what's
    under test)."""
    from linprog_tpu import calibration

    out = calibration.calibrate(sizes=(16,), lanes=4, seg_grid=(8, 16),
                                pdhg_sizes=(16,), pdhg_lanes=4)
    (kind, table), = out.items()
    assert kind == "cpu"
    assert set(table["_measured"]) == set(calibration.REQUIRED_KEYS)
    assert table["exact_eps"] >= 1e-5  # the moderate IPM's own floor
    assert table["seg_by_m"][0][0] == 16  # measured knee row
    assert table["seg_by_m"][-1][0] == 0  # terminal row retained


def test_shipped_calibration_has_no_copied_chip_entries():
    """Every device entry in the packaged data file except the CPU test
    routing must carry a '_measured' provenance list (i.e. come from
    calibrate())."""
    import json

    from linprog_tpu.calibration import _DATA_PATH

    with open(_DATA_PATH) as f:
        data = json.load(f)
    for kind, entry in data.items():
        if kind in ("_comment", "cpu"):
            continue
        assert "_measured" in entry, (
            f"chip entry {kind!r} lacks measurement provenance"
        )


def test_exact_fallback_retries_crossover_beyond_tuned_seg_boundary():
    """Beyond ``cleanup_tuned_seg_max_m``, uncrossed lanes first get an
    IPM->crossover RETRY with the alternate guess (the two-phase fallback
    costs thousands of pivots per lane there); only still-uncrossed lanes
    fall to the two-phase.  Exercised on CPU by shrinking the boundary via
    an injected calibration table."""
    from linprog_tpu import calibration

    B, m, n = 8, 20, 20
    c, G, h = random_inequality_lps(B, m, n, seed=31)
    c, G, h = jnp.asarray(c), jnp.asarray(G), jnp.asarray(h)
    cfg = SolverConfig(pricing="dantzig", refactor_every=64,
                       polish_pivots=8)
    table = dict(calibration.get_table("cpu"))
    table["cleanup_tuned_seg_max_m"] = 8  # m=20 now routes the tight cadence
    try:
        calibration.set_table({"cpu": table})
        # a starved budget leaves lanes uncrossed; the retry at double
        # budget must repair them before any two-phase fallback runs
        res, info = solve_batch_exact(c, G, h, cfg=cfg, maxiters=6)
    finally:
        calibration.reset_table()
    s = np.asarray(res.status)
    assert (s == 1).all(), (s, info)
    assert info["crossed"] + info["fallback"] >= B
    # bookkeeping: every lane accounted crossed (incl. retries) or fallback
    assert info["retry_crossed"] >= 0
    ref_costs = []
    from scipy.optimize import linprog as slp

    for i in range(B):
        ref = slp(np.asarray(c[i]), A_ub=np.asarray(G[i]),
                  b_ub=np.asarray(h[i]), bounds=(0, None), method="highs")
        if ref.status == 0:
            gap = abs(float(res.cost[i]) - ref.fun) / max(1, abs(ref.fun))
            assert gap < 1e-4, (i, gap)
