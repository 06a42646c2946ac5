"""linprog_tpu: a batched linear-programming framework in JAX.

A JAX/XLA design with the capability surface of the reference NumPy library
agmuth/linear-programming (see SURVEY.md): primal and dual revised simplex,
two-phase method, bounded-variable simplex, the primal-dual algorithm, and a
general-form front end -- plus what the reference never had: a fully batched
``vmap`` mode, mesh sharding across devices, device-side status codes, and
an explicit checkpointable solver state.  It runs on NVIDIA GPUs (measured
on an H100) and, for the test suite, on the CPU.
"""

import jax as _jax

# On NVIDIA GPUs XLA may run f32 matmuls on the tensor cores as TF32 (10
# mantissa bits, ~1e-3 relative error): reduced costs then flip pivot
# selections and stop simplex at wrong vertices, and PDHG stops converging.
# Every matmul/einsum in the package must therefore run at HIGHEST (full
# f32) precision -- enforced globally here so no code path (TP, bounded,
# primal-dual) can silently regress; chip_smoke.py checks it on the card.
# Explicit ``precision=`` kwargs at dot_general call sites remain as local
# documentation.
_jax.config.update("jax_default_matmul_precision", "highest")

from .api import (
    BoundedVariablePrimalSimplexSolver,
    DualNaiveSimplexSolver,
    DualRevisedSimplexSolver,
    PhaseOneSimplexSolver,
    PrimalNaiveSimplexSolver,
    PrimalRevisedSimplexSolver,
    SimplexSolver,
)
from .crossover import (
    crossover_batch_canonical,
    ipm_crossover_batch_canonical,
    pdhg_crossover_batch_canonical,
)
from .ipm import (
    IPMConfig,
    IPMSolver,
    ipm_solve_batch_canonical,
    ipm_solve_batch_standard,
    recover_stragglers_pooled,
    reoptimize_ipm_batch_canonical,
    warm_start_point,
)
from .ipm_sparse import (
    SparsePattern,
    ipm_solve_batch_sparse_canonical,
    recover_stragglers_sparse,
)
from .pdhg import PDHGConfig, PDHGSolver
from .primal_dual import PrimalDualAlgorithm
from .router import (
    choose_family,
    choose_family_sparse,
    solve_batch_auto,
    solve_batch_auto_sparse,
    solve_batch_exact,
)
from .presolve_host import presolve_problem, solve_with_presolve
from .ranging import RangingResult, ranging, ranging_batch
from .config import DEFAULT_CONFIG, FAST_CONFIG, SolverConfig, tuned_config
from .engine import SimplexState
from .results import BatchResult, LinProgResult
from .status import (
    BasisIsDualInfeasibleError,
    BasisIsPrimalInfeasibleError,
    DualIsInfeasibleError,
    DualIsUnboundedError,
    LinProgError,
    PrimalIsInfeasibleError,
    PrimalIsUnboundedError,
)

__version__ = "0.4.0"

__all__ = [
    "PrimalNaiveSimplexSolver",
    "PrimalRevisedSimplexSolver",
    "DualNaiveSimplexSolver",
    "DualRevisedSimplexSolver",
    "PhaseOneSimplexSolver",
    "BoundedVariablePrimalSimplexSolver",
    "PrimalDualAlgorithm",
    "PDHGSolver",
    "PDHGConfig",
    "IPMSolver",
    "IPMConfig",
    "ipm_solve_batch_standard",
    "ipm_solve_batch_canonical",
    "recover_stragglers_pooled",
    "reoptimize_ipm_batch_canonical",
    "warm_start_point",
    "SparsePattern",
    "ipm_solve_batch_sparse_canonical",
    "solve_batch_auto",
    "solve_batch_auto_sparse",
    "choose_family_sparse",
    "recover_stragglers_sparse",
    "solve_batch_exact",
    "choose_family",
    "SimplexSolver",
    "SolverConfig",
    "DEFAULT_CONFIG",
    "FAST_CONFIG",
    "tuned_config",
    "SimplexState",
    "LinProgResult",
    "BatchResult",
    "LinProgError",
    "BasisIsPrimalInfeasibleError",
    "BasisIsDualInfeasibleError",
    "PrimalIsUnboundedError",
    "PrimalIsInfeasibleError",
    "DualIsUnboundedError",
    "DualIsInfeasibleError",
    "crossover_batch_canonical",
    "ipm_crossover_batch_canonical",
    "pdhg_crossover_batch_canonical",
    "ranging",
    "ranging_batch",
    "RangingResult",
    "presolve_problem",
    "solve_with_presolve",
]
