"""Compat: reference ``linprog/utils.py`` -> JAX kernel utilities.

The divisions return NumPy arrays here (the reference surface is NumPy);
device-side callers should use :mod:`linprog_tpu.utils` directly.
"""

import numpy as np

from linprog_tpu import utils as _u


def primal_simplex_div(numerator, denominator):
    return np.asarray(_u.primal_simplex_div(numerator, denominator))


def dual_simplex_div(numerator, denominator):
    return np.asarray(_u.dual_simplex_div(numerator, denominator))


def get_bounds_on_bfs(A, b):
    return float(_u.get_bounds_on_bfs(A, b))


__all__ = ["primal_simplex_div", "dual_simplex_div", "get_bounds_on_bfs"]
