"""Solver configuration.

The reference (agmuth/linear-programming) has no config system: all knobs are
constructor/``solve`` kwargs and hardcoded ``np.isclose`` tolerances at 8 call
sites (reference ``linprog/primal_solvers.py:142``, ``linprog/dual_solvers.py:54``,
``linprog/special_solvers.py:405``).  This package replaces those with one
frozen, hashable dataclass that is passed as a *static* jit argument, so every
tolerance / rule choice specializes the compiled program.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

# bfloat16 is deliberately NOT offered: basis factors and reduced costs
# need f32 at minimum (see docs/DESIGN.md on matmul precision), and a bf16
# dtype option would silently produce wrong pivots.
_DTYPES = {
    "float32": jnp.float32,
    "float64": jnp.float64,
}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for the simplex engine.

    Attributes
    ----------
    opt_tol:
        Optimality tolerance on reduced costs (primal) / entering eligibility.
        The reference uses ``np.isclose(min, 0)`` (atol ``1e-8``) under float32
        (``primal_solvers.py:140-142``); we default to ``1e-6`` which is robust
        for float32 while meeting the 1e-6 relative-objective target.
    feas_tol:
        Feasibility tolerance on basic variable values (dual optimality check,
        basis-feasibility gates).
    pivot_tol:
        Minimum magnitude for a ratio-test denominator / pivot element.  The
        reference divides by any strictly positive entry
        (``linprog/utils.py:5-17``); a small positive floor avoids float32
        blowups on near-degenerate columns.
    update:
        ``"eta"``   -- product-form-of-the-inverse rank-1 update per pivot
        (reference ``PrimalRevisedSimplexSolver``, ``primal_solvers.py:212-263``).
        ``"naive"`` -- re-invert ``A[:, basis]`` every pivot (reference
        ``PrimalNaiveSimplexSolver``, ``primal_solvers.py:94``).
    pricing:
        ``"bland"``   -- first eligible column (anti-cycling; reference default,
        ``primal_solvers.py:135-138``).
        ``"dantzig"`` -- most-negative reduced cost (faster in practice).
        ``"devex"``   -- reference-weight pricing (Forrest-Goldfarb),
        implemented on the batched primal loop; paths without an
        implementation (single-instance engine, dual solves) raise
        ``ValueError`` at dispatch -- the knob never silently serves a
        different rule.  On the structured suite devex ~= dantzig in pivot
        counts (see tests/test_structured_suite.py), so dantzig remains
        the tuned default.
    refactor_every:
        If > 0 and ``update == "eta"``, recompute ``inv(A[:, basis])`` from
        scratch every ``refactor_every`` pivots to bound eta-product drift.
        0 disables refactorization (exact reference behavior).
    dtype:
        Numeric dtype name for problem data and factors.  The reference casts
        everything to float32 (``preprocessing.py:7-9``).
    """

    opt_tol: float = 1e-6
    feas_tol: float = 1e-6
    # 1e-7 (not the reference's divide-by-anything-positive): in f32 a
    # pivot element of ~1e-9-1e-8 -- reachable via refactorization noise on
    # degenerate instances -- sends the basis condition number past 1/eps,
    # the next refactorization inverts a numerically singular matrix, and
    # NaN pricing silently reads as "optimal" (caught by the structured
    # covering instance; see also the non-finite-factor guards in
    # engine_batched).
    pivot_tol: float = 1e-7
    update: str = "eta"
    pricing: str = "bland"
    refactor_every: int = 0
    # Stalled-lane escalation (anti-cycling for the fast pricing rules):
    # if a lane's objective makes no relative progress (> ~1e-6) for
    # `stall_limit` consecutive pivots under dantzig/devex pricing, the lane
    # flips to Bland's rule (provably cycle-free) until progress resumes.
    # Dantzig provably cycles on degenerate LPs (Beale 1955; pinned by
    # tests/test_degeneracy.py) -- without this, one degenerate lane burns
    # the whole batch's iteration budget.  0 disables (exact legacy paths).
    # Applied in the batched primal loop (engine_batched.run_batched).
    stall_limit: int = 24
    # Terminal double-word polish (linprog_tpu.refine): after the batched
    # two-phase solve, reduced costs are recomputed in split-float/Kahan
    # arithmetic at the terminal basis and up to `polish_pivots` dd-guided
    # cleanup pivots fix the near-optimal vertices f32 pricing cannot
    # distinguish from optimal.  0 disables.  Cost: a few O(mn) passes at
    # the end of the solve (~<10% of total).
    polish_pivots: int = 0
    # Compact the between-segment/chunk exact refactorization to the
    # still-running lanes: the batched inversion otherwise runs over ALL
    # lanes every segment even when only a tail of the batch is still
    # active.  Running lanes are stably sorted to the front and only the
    # smallest power-of-two prefix covering them is inverted (lax.switch)
    # -- bit-exact per running lane, so pivot paths are unchanged.
    compact_refactor: bool = True
    dtype: str = "float32"
    # refactorization method between chunks of the batched primal loop:
    # "inv" -- exact batched inversion (O(m^3) LU), the only method.
    # "ns" (Newton-Schulz refinement) ran only in the removed
    # hand-written kernel drivers and is rejected; the field goes with
    # ROADMAP Queue 3.
    refactor_method: str = "inv"
    # Ruiz equilibration of (c, A, b) before solving (batched pipelines);
    # results are reported in the original scaling.
    scaling: bool = False

    def __post_init__(self):
        if self.update not in ("eta", "naive"):
            raise ValueError(f"unknown update rule: {self.update!r}")
        if self.pricing not in ("bland", "dantzig", "devex"):
            raise ValueError(f"unknown pricing rule: {self.pricing!r}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype: {self.dtype!r}")
        if self.refactor_method == "ns":
            raise ValueError(
                "refactor_method='ns' is no longer supported: it ran only "
                "in the removed hand-written kernel drivers; use 'inv'")
        if self.refactor_method != "inv":
            raise ValueError(f"unknown refactor method: {self.refactor_method!r}")

    @property
    def jnp_dtype(self):
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SolverConfig()

# The throughput configuration: dantzig pricing with stalled-lane Bland
# escalation, compact refactorization every segment (length per size from
# the calibration table, see :func:`tuned_config`) and the double-word
# terminal polish.  DEFAULT_CONFIG keeps the reference-parity semantics
# (bland, no refactorization) for oracle-exact pivot paths; use
# FAST_CONFIG (or :func:`tuned_config`) for throughput.
FAST_CONFIG = SolverConfig(
    pricing="dantzig",
    refactor_every=512,
    polish_pivots=8,
)


def tuned_config(m: int, **overrides) -> SolverConfig:
    """:data:`FAST_CONFIG` with the segment length tuned for size ``m``.

    The refactor-segment knees are per-device measurements read from the
    calibration table (``linprog_tpu/data/calibration.json``, key
    ``seg_by_m``).  ``overrides`` are applied last.
    """
    from .calibration import seg_for_m

    seg = overrides.pop("refactor_every", None)
    if seg is None:
        seg = seg_for_m(m)
    return FAST_CONFIG.replace(refactor_every=seg, **overrides)
