"""Compat: reference ``linprog/simplex.py`` -> JAX general solver."""

from linprog_tpu.api import SimplexSolver

__all__ = ["SimplexSolver"]
