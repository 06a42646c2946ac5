"""Per-device calibration of solver-family regime boundaries.

The auto-router's crossover points (simplex / IPM / IPM+crossover / PDHG),
the crossover-cleanup cadence and the tuned refactor-segment knees are
MEASUREMENTS, not constants.  This module keeps them in ONE data file
(``linprog_tpu/data/calibration.json``) keyed by JAX's ``device_kind``
and exposes:

* :func:`get_table` -- the table for the current (or named) device.  It
  reads the JSON file once, honors the ``LINPROG_TPU_CALIBRATION`` env var
  (a path to an override file) and any :func:`set_table` injection.  A
  device with no entry is an error, never a silent default: routing one
  device by another's timings picks the wrong family.
* :func:`set_table` / :func:`reset_table` -- programmatic override, used
  by tests (an injected fake-measurement table must flip the routing).
* :func:`calibrate` -- measure every threshold on the LIVE device and
  return a table dict (optionally persisting it).
"""

from __future__ import annotations

import json
import os
from typing import Optional

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data",
                          "calibration.json")

REQUIRED_KEYS = (
    "exact_simplex_max_m", "moderate_simplex_max_m", "pdhg_min_m",
    "exact_eps", "cleanup_tuned_seg_max_m", "seg_by_m",
)

CALIBRATE_COMMAND = (
    "python -c \"from linprog_tpu.calibration import calibrate; "
    "calibrate(save_path='calibration_new.json')\""
)

_file_cache: Optional[dict] = None
_override: Optional[dict] = None


class UncalibratedDeviceError(LookupError):
    """The calibration table has no (complete) entry for this device."""


def _load_file() -> dict:
    global _file_cache
    if _file_cache is None:
        path = os.environ.get("LINPROG_TPU_CALIBRATION", _DATA_PATH)
        with open(path) as f:
            _file_cache = json.load(f)
    return _file_cache


def set_table(table: dict) -> None:
    """Inject a calibration table (same schema as the JSON file).

    ``table`` maps ``device_kind`` names to threshold dicts.  Takes
    precedence over the data file until :func:`reset_table`.
    """
    global _override
    _override = table


def reset_table() -> None:
    """Drop any :func:`set_table` injection (reload from the data file)."""
    global _override, _file_cache
    _override = None
    _file_cache = None


def _device_kind() -> str:
    import jax

    return jax.devices()[0].device_kind


def get_table(device_kind: Optional[str] = None) -> dict:
    """Threshold dict for ``device_kind`` (default: the live device).

    Raises :class:`UncalibratedDeviceError` when the table has no entry
    for that device, or an entry that lacks one of :data:`REQUIRED_KEYS`;
    the message names the command that measures one.
    """
    src = _override if _override is not None else _load_file()
    kind = device_kind or _device_kind()
    entry = src.get(kind)
    if entry is None:
        raise UncalibratedDeviceError(
            f"no calibration entry for device_kind {kind!r} (known: "
            f"{sorted(k for k in src if not k.startswith('_'))}).  Measure "
            f"one on that device with {CALIBRATE_COMMAND} and add its "
            f"entry to linprog_tpu/data/calibration.json."
        )
    missing = [k for k in REQUIRED_KEYS if k not in entry]
    if missing:
        raise UncalibratedDeviceError(
            f"calibration entry for {kind!r} lacks {missing}; re-measure "
            f"it with {CALIBRATE_COMMAND}."
        )
    return dict(entry)


def seg_for_m(m: int, device_kind: Optional[str] = None) -> int:
    """Tuned refactor-segment length for problem size ``m`` (see
    ``config.tuned_config``).  The table rows are ``[hi, seg]`` with
    ``hi == 0`` meaning "everything larger"."""
    for hi, seg in get_table(device_kind)["seg_by_m"]:
        if hi == 0 or m <= hi:
            return int(seg)
    raise AssertionError("calibration seg_by_m has no terminal row")


def calibrate(sizes=(128, 256, 512), lanes: int = 64, seed: int = 0,
              save_path: Optional[str] = None,
              seg_grid=(256, 512, 768, 1024),
              pdhg_sizes=(1024, 2048), pdhg_lanes: int = 16) -> dict:
    """Measure EVERY routing threshold on the live device.

    Per size in ``sizes`` (``lanes`` random dense instances, one warm-up
    run excluded from every timing):

    * ``seg_by_m`` -- the refactor-segment knee: the two-phase simplex
      batch timed at each ``seg_grid`` value, argmin kept.  Rows beyond
      the grid are kept from this device's existing entry, if any; else
      the largest size's knee becomes the terminal row.
    * ``moderate_simplex_max_m`` -- simplex (at its best seg) vs the RAW
      batched IPM, the leg the moderate-accuracy router actually
      dispatches (the round-4 version compared against the slower exact
      pipeline and over-extended the simplex regime).
    * ``exact_simplex_max_m`` -- simplex vs the IPM->crossover exact
      pipeline at ITS best cleanup config.
    * ``cleanup_tuned_seg_max_m`` -- the largest size where the crossover
      cleanup at the tuned segment length (``tuned_config(m)``, budget
      512) beats the tight-refactor cadence (``refactor_every`` 128,
      budget 2048); see :func:`linprog_tpu.router.exact_cleanup_config`.
      It also decides the repair order in
      :func:`linprog_tpu.router.solve_batch_exact`: beyond it (below
      m=1536) lanes that fail to cross retry with the alternate basis
      guess before the two-phase fallback.
    * ``exact_eps`` -- the accuracy-class boundary, derived from the RAW
      IPM's measured per-lane KKT floor (median of primal-residual /
      duality-gap scores at a tight target): requests below
      ``10^floor(log10(floor/30))`` need the vertex-exact pipeline.  It
      is never below 1e-5: the router's moderate-accuracy IPM runs at
      ``eps_rel >= 1e-5``, so a tighter request must go exact.
    * ``pdhg_min_m`` -- PDHG vs raw IPM at the loose accuracy class
      (eps 1e-4) over ``pdhg_sizes``; the smallest size where PDHG wins,
      or twice the largest measured size if it never does ("beyond the
      measured grid").

    Returns ``{device_kind: thresholds}`` with a ``"_measured"`` list
    naming the keys derived from live timings; pass ``save_path`` to
    persist a file loadable via ``LINPROG_TPU_CALIBRATION`` or
    :func:`set_table`.
    """
    import math
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from .batch import solve_batch_two_phase
    from .config import tuned_config
    from .crossover import ipm_crossover_batch_canonical
    from .generators import (
        device_inequality_lps,
        device_standard_form_batch,
    )
    from .ipm import IPMConfig, ipm_solve_batch_canonical

    kind = _device_kind()
    src = _override if _override is not None else _load_file()
    table = dict(src.get(kind, {}))
    measured = []

    def _time(fn):
        fn()  # warm-up (compile)
        t0 = time.time()
        fn()
        return time.time() - t0

    exact_wins, moderate_wins, tuned_wins, seg_rows = [], [], [], []
    floor_scores = []
    for m in sizes:
        key = jax.random.PRNGKey(seed)
        c, G, h = device_inequality_lps(key, lanes, m, m)
        cs, As, bs = device_standard_form_batch(c, G, h)
        it = max(2000, 4 * m)

        # --- refactor-segment knee -----------------------------------
        best_seg, t_simplex = None, None
        for seg in seg_grid:
            if seg > 2 * it:
                continue
            cfg = tuned_config(m, refactor_every=int(seg))

            def simplex(cfg=cfg):
                np.asarray(
                    solve_batch_two_phase(cs, As, bs, it, it, cfg).cost
                )

            t = _time(simplex)
            if t_simplex is None or t < t_simplex:
                best_seg, t_simplex = int(seg), t
        seg_rows.append([int(m), best_seg])

        # --- raw IPM (the moderate-accuracy leg) ---------------------
        def ipm_raw():
            r = ipm_solve_batch_canonical(c, G, h, IPMConfig(),
                                          recover=False)
            np.asarray(r.cost)
            return r

        t_ipm = _time(ipm_raw)
        moderate_wins.append((m, t_simplex <= t_ipm))

        # --- KKT floor of the raw IPM (for exact_eps) ----------------
        r = ipm_solve_batch_canonical(
            c, G, h, IPMConfig(eps_rel=1e-7, maxiters=60), recover=False
        )
        n = c.shape[1]
        xu = np.asarray(r.x)[:, :n]
        y = np.asarray(r.y)
        hn = np.asarray(h)
        cn = np.asarray(c)
        Gn = np.asarray(G)
        pr = np.linalg.norm(
            np.maximum(np.einsum("bmn,bn->bm", Gn, xu) - hn, 0.0), axis=1
        ) / (1.0 + np.linalg.norm(hn, axis=1))
        gap = np.abs(
            np.asarray(r.cost) - np.einsum("bm,bm->b", hn, y)
        ) / (1.0 + np.abs(np.asarray(r.cost)))
        floor_scores.append(np.median(np.maximum(pr, gap)))

        # --- exact pipeline at its best cleanup config ---------------
        def exact(cfg, budget):
            rr, _crossed = ipm_crossover_batch_canonical(
                c, G, h, crossover_maxiters=budget, cfg=cfg
            )
            np.asarray(rr.cost)

        candidates = [
            ("tuned", tuned_config(m, refactor_every=best_seg),
             max(256, min(512, 2 * it))),
            ("tight",
             tuned_config(m, refactor_every=min(128, max(32, m // 4))),
             max(512, min(2048, 4 * it))),
        ]
        times = {
            name: _time(lambda cfg=cfg, b=b: exact(cfg, b))
            for name, cfg, b in candidates
        }
        tuned_wins.append((m, times["tuned"] <= times["tight"]))
        exact_wins.append((m, t_simplex <= min(times.values())))

    def _largest_win(wins):
        best = 0
        for m, won in wins:
            if won:
                best = m
            else:
                break
        return best

    table["exact_simplex_max_m"] = _largest_win(exact_wins)
    table["moderate_simplex_max_m"] = _largest_win(moderate_wins)
    measured += ["exact_simplex_max_m", "moderate_simplex_max_m"]

    table["cleanup_tuned_seg_max_m"] = _largest_win(tuned_wins)
    measured.append("cleanup_tuned_seg_max_m")

    if floor_scores:
        floor = float(np.median(floor_scores))
        if floor > 0:
            table["exact_eps"] = max(1e-5, float(
                10.0 ** math.floor(math.log10(max(floor / 30.0, 1e-7)))
            ))
            measured.append("exact_eps")

    # measured knees for the sizes covered; rows BEYOND the measured grid
    # (larger-m knees and the terminal row) are kept from this device's
    # existing entry -- replacing them with a terminal guess would mis-seg
    # every size between max(sizes) and the old knees
    max_measured = max(sizes)
    keep = [r for r in table.get("seg_by_m", [])
            if r[0] == 0 or r[0] > max_measured]
    table["seg_by_m"] = seg_rows + (keep or [[0, seg_rows[-1][1]]])
    measured.append("seg_by_m")

    # --- PDHG regime boundary (loose accuracy class) -----------------
    if pdhg_sizes:
        from .pdhg import PDHGConfig, pdhg_solve_batch_canonical

        pdhg_min = None
        for m in pdhg_sizes:
            key = jax.random.PRNGKey(seed + 1)
            c, G, h = device_inequality_lps(key, pdhg_lanes, m, m)

            def ipm_loose():
                r = ipm_solve_batch_canonical(
                    c, G, h, IPMConfig(eps_rel=1e-4), recover=False
                )
                np.asarray(r.cost)

            pcfg = PDHGConfig(eps_rel=1e-4, adaptive=False)

            def pdhg():
                x, cost, _status, _iters = pdhg_solve_batch_canonical(
                    c, G, h, maxiters=40_000, cfg=pcfg
                )
                np.asarray(cost)

            if _time(pdhg) < _time(ipm_loose):
                pdhg_min = int(m)
                break
        table["pdhg_min_m"] = (pdhg_min if pdhg_min is not None
                               else 2 * int(max(pdhg_sizes)))
        measured.append("pdhg_min_m")

    table["_measured"] = measured
    # regime boundaries depend on the BATCH SCALE as well as (m,
    # accuracy): the pivot loop's fixed costs amortize over lanes.
    # Record the probe scale so a saved entry is never mistaken for an
    # at-scale one.
    table["_provenance"] = {
        "lanes": int(lanes), "sizes": [int(s) for s in sizes],
        "pdhg_sizes": [int(s) for s in pdhg_sizes],
        "pdhg_lanes": int(pdhg_lanes),
    }
    out = {kind: table}
    if save_path:
        with open(save_path, "w") as f:
            json.dump(out, f, indent=1)
    return out
