"""Compat: reference ``linprog/special_solvers.py`` -> JAX engines."""

from linprog_tpu.api import (
    BoundedVariablePrimalSimplexSolver,
    PhaseOneSimplexSolver,
)
from linprog_tpu.primal_dual import PrimalDualAlgorithm

__all__ = [
    "PhaseOneSimplexSolver",
    "BoundedVariablePrimalSimplexSolver",
    "PrimalDualAlgorithm",
]
