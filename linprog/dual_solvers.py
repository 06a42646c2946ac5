"""Compat: reference ``linprog/dual_solvers.py`` -> JAX engines."""

from linprog_tpu.api import (
    DualNaiveSimplexSolver,
    DualRevisedSimplexSolver,
)

__all__ = ["DualNaiveSimplexSolver", "DualRevisedSimplexSolver"]
