"""Compat: reference ``linprog/primal_solvers.py`` -> JAX engines."""

from linprog_tpu.api import (
    PrimalNaiveSimplexSolver,
    PrimalRevisedSimplexSolver,
)

__all__ = ["PrimalNaiveSimplexSolver", "PrimalRevisedSimplexSolver"]
