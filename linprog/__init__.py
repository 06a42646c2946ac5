"""Drop-in compatibility package for reference `linprog` users.

The reference library (agmuth/linear-programming) is imported as
``linprog.<module>``; this package mirrors its module layout
(``simplex``, ``primal_solvers``, ``dual_solvers``, ``special_solvers``,
``preprocessing``, ``utils``, ``data_classes``, ``exceptions``) and
re-exports the JAX implementations under the reference names, so
existing user code switches backends by switching nothing at all.

The reference's ``linprog/__init__.py`` is empty (no exports); ours re-exports
the solver classes for convenience but keeps the per-module import paths
working identically.
"""

from linprog_tpu import (
    BoundedVariablePrimalSimplexSolver,
    DualNaiveSimplexSolver,
    DualRevisedSimplexSolver,
    LinProgResult,
    PhaseOneSimplexSolver,
    PrimalDualAlgorithm,
    PrimalNaiveSimplexSolver,
    PrimalRevisedSimplexSolver,
    SimplexSolver,
)

__all__ = [
    "PrimalNaiveSimplexSolver",
    "PrimalRevisedSimplexSolver",
    "DualNaiveSimplexSolver",
    "DualRevisedSimplexSolver",
    "PhaseOneSimplexSolver",
    "BoundedVariablePrimalSimplexSolver",
    "PrimalDualAlgorithm",
    "SimplexSolver",
    "LinProgResult",
]
