"""Compat: reference ``linprog/preprocessing.py`` -> JAX forms.

The reference exposes ``ProblemPreprocessingUtils`` with three staticmethods;
this shim maps them onto :mod:`linprog_tpu.forms`.
"""

from linprog_tpu import forms


class ProblemPreprocessingUtils:
    @staticmethod
    def preprocess_problem(c, A, b):
        return forms.preprocess_problem(c, A, b)

    @staticmethod
    def canonical_form_to_standard_form(c, G, h):
        return forms.canonical_to_standard(c, G, h)

    @staticmethod
    def add_variables_bounds_to_coefficient_matrix(c, A, b, lb, ub):
        return forms.bounds_to_rows(c, A, b, lb, ub)


__all__ = ["ProblemPreprocessingUtils"]
