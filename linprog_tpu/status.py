"""Device-side status codes and the host-side exception taxonomy.

The reference surfaces solver outcomes as six exception classes raised
mid-iteration (reference ``linprog/exceptions.py:1-22``).  Exceptions cannot
cross ``jit``/``vmap`` boundaries, so the engine computes a per-instance
*status code* branchlessly inside the compiled loop, and a thin host wrapper
re-raises the matching exception for API parity with the reference.
"""

from __future__ import annotations

import jax.numpy as jnp

# Device-side status codes (int32).  RUNNING must be 0 so a freshly
# zero-initialized lane is "live".
RUNNING = 0
OPTIMAL = 1
ITER_LIMIT = 2
PRIMAL_UNBOUNDED = 3
PRIMAL_INFEASIBLE = 4
DUAL_UNBOUNDED = 5
DUAL_INFEASIBLE = 6
BASIS_PRIMAL_INFEASIBLE = 7
BASIS_DUAL_INFEASIBLE = 8
NUMERICAL_ERROR = 9

STATUS_NAMES = {
    RUNNING: "RUNNING",
    OPTIMAL: "OPTIMAL",
    ITER_LIMIT: "ITER_LIMIT",
    PRIMAL_UNBOUNDED: "PRIMAL_UNBOUNDED",
    PRIMAL_INFEASIBLE: "PRIMAL_INFEASIBLE",
    DUAL_UNBOUNDED: "DUAL_UNBOUNDED",
    DUAL_INFEASIBLE: "DUAL_INFEASIBLE",
    BASIS_PRIMAL_INFEASIBLE: "BASIS_PRIMAL_INFEASIBLE",
    BASIS_DUAL_INFEASIBLE: "BASIS_DUAL_INFEASIBLE",
    NUMERICAL_ERROR: "NUMERICAL_ERROR",
}


# Host-side exception taxonomy -- names match the reference classes
# (reference ``linprog/exceptions.py``) one for one.
class LinProgError(Exception):
    """Base class for all solver errors."""


class BasisIsPrimalInfeasibleError(LinProgError):
    pass


class BasisIsDualInfeasibleError(LinProgError):
    pass


class PrimalIsUnboundedError(LinProgError):
    pass


class PrimalIsInfeasibleError(LinProgError):
    pass


class DualIsUnboundedError(LinProgError):
    pass


class DualIsInfeasibleError(LinProgError):
    pass


_STATUS_TO_EXC = {
    PRIMAL_UNBOUNDED: PrimalIsUnboundedError,
    PRIMAL_INFEASIBLE: PrimalIsInfeasibleError,
    DUAL_UNBOUNDED: DualIsUnboundedError,
    DUAL_INFEASIBLE: DualIsInfeasibleError,
    BASIS_PRIMAL_INFEASIBLE: BasisIsPrimalInfeasibleError,
    BASIS_DUAL_INFEASIBLE: BasisIsDualInfeasibleError,
}


def raise_for_status(status) -> int:
    """Re-raise the reference exception matching a terminal error status.

    ``OPTIMAL``, ``RUNNING`` and ``ITER_LIMIT`` are not errors: the reference
    returns ``optimum=False`` when ``maxiters`` is hit without converging
    (reference ``primal_solvers.py:176-191``).
    """
    code = int(status)
    exc = _STATUS_TO_EXC.get(code)
    if exc is not None:
        raise exc(STATUS_NAMES.get(code, str(code)))
    return code


def is_terminal(status):
    return status != RUNNING


def status_name(status) -> str:
    return STATUS_NAMES.get(int(status), f"UNKNOWN({int(status)})")


def as_status(value):
    return jnp.asarray(value, dtype=jnp.int32)
