"""Unit tests for canonicalization and kernel utilities."""

import numpy as np
import pytest

from linprog_tpu import forms
from linprog_tpu.utils import (
    dual_simplex_div,
    get_bounds_on_bfs,
    primal_simplex_div,
)


def test_preprocess_sign_fix():
    c, A, b = forms.preprocess_problem(
        [1, 2], [[1, 2], [-3, 4]], [-5, 6], np.float32
    )
    assert (b >= 0).all()
    assert np.allclose(A[0], [-1, -2])  # row flipped with b
    assert np.allclose(b, [5, 6])
    assert A.dtype == np.float32


def test_canonical_to_standard_adds_slack_identity():
    c, A, b = forms.canonical_to_standard([1.0], [[2.0], [3.0]], [4.0, 5.0])
    assert A.shape == (2, 3)
    assert np.allclose(A[:, 1:], np.eye(2))
    assert np.allclose(c, [1, 0, 0])


def test_bounds_to_rows_layout():
    c, A, b = forms.bounds_to_rows(
        [1.0, 1.0],
        [[1.0, 1.0]],
        [3.0],
        lb=[0.5, 0.0],
        ub=[np.inf, 2.0],
    )
    # one lb row (x1 - s = 0.5), one ub row (x2 + s = 2)
    assert A.shape == (3, 4)
    assert np.allclose(b, [3, 0.5, 2])
    assert A[1, 0] == 1 and A[1, 2] == -1
    assert A[2, 1] == 1 and A[2, 3] == 1


def test_bounds_to_rows_skips_infinite_lb():
    c, A, b = forms.bounds_to_rows(
        [1.0], [[1.0]], [1.0], lb=[-np.inf], ub=[np.inf]
    )
    assert A.shape == (1, 1)  # no rows added
    assert np.isfinite(b).all()


def test_ratio_divisions():
    n = np.array([1.0, 2.0, 3.0])
    d = np.array([2.0, -1.0, 0.0])
    out = np.asarray(primal_simplex_div(n, d))
    assert out[0] == pytest.approx(0.5)
    assert np.isinf(out[1]) and np.isinf(out[2])
    out = np.asarray(dual_simplex_div(n, d))
    assert np.isinf(out[0]) and np.isinf(out[2])
    assert out[1] == pytest.approx(2.0)


def test_bfs_bound_matches_exact_formula_small_m():
    from math import factorial

    A = np.array([[2.0, 1.0], [1.0, 3.0]])
    b = np.array([4.0, 5.0])
    exact = factorial(2) * 3.0 ** (2 - 1) * 5.0
    got = float(get_bounds_on_bfs(A, b))
    assert got == pytest.approx(exact, rel=1e-4)


def test_bfs_bound_does_not_overflow_large_m():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(256, 256)).astype(np.float32)
    b = rng.normal(size=256).astype(np.float32)
    got = float(get_bounds_on_bfs(A, b))
    assert np.isfinite(got) and got > 0


def test_pad_problem_preserves_solution_space():
    c = np.array([1.0, 2.0])
    A = np.array([[1.0, 1.0]])
    b = np.array([3.0])
    c2, A2, b2, row_mask, col_mask = forms.pad_problem(c, A, b, 3, 6)
    assert A2.shape == (3, 6)
    assert b2.shape == (3,)
    assert row_mask.sum() == 1 and col_mask.sum() == 2
    # padded rows are satisfied by zeros on the padding columns
    assert np.allclose(A2[1:, :2], 0)
    assert np.allclose(b2[1:], 0)


def test_fast_and_tuned_configs():
    from linprog_tpu.config import FAST_CONFIG, tuned_config

    assert FAST_CONFIG.pricing == "dantzig" and FAST_CONFIG.polish_pivots
    assert FAST_CONFIG.compact_refactor and FAST_CONFIG.stall_limit > 0
    assert tuned_config(256).refactor_every == 512
    assert tuned_config(512).refactor_every == 768
    assert tuned_config(1024).refactor_every == 1024
    assert tuned_config(4096).refactor_every == 2048
    # overrides win
    assert tuned_config(256, polish_pivots=0).polish_pivots == 0
    # usable as a static jit arg (hashable/frozen)
    hash(tuned_config(256))
