"""Tiny NumPy oracle: step-by-step pivot-path ground truth.

An independent, host-side revised-simplex implementation (written fresh, not
ported) used by the test suite to validate the JAX engine pivot-by-pivot:
same Bland/Dantzig selection semantics, same ratio test, explicit basis
trace.  Because it shares no code with the engine, agreement on random
instances is strong evidence both are right.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class OracleSimplex:
    """Primal revised simplex with a recorded pivot trace."""

    def __init__(self, c, A, b, basis, pricing: str = "bland", tol: float = 1e-9):
        self.c = np.asarray(c, dtype=np.float64)
        self.A = np.asarray(A, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)
        neg = self.b < 0
        self.A[neg] *= -1
        self.b[neg] *= -1
        self.basis = np.asarray(basis, dtype=int).copy()
        self.inv_B = np.linalg.inv(self.A[:, self.basis])
        self.x_B = self.inv_B @ self.b
        self.pricing = pricing
        self.tol = tol
        self.trace: List[Tuple[int, int]] = []  # (enter, leave_pos) per pivot
        self.basis_trace: List[np.ndarray] = [self.basis.copy()]
        self.status = "running"

    def reduced_costs(self) -> np.ndarray:
        y = self.c[self.basis] @ self.inv_B
        r = self.c - y @ self.A
        r[self.basis] = 0.0
        return r

    def step(self) -> bool:
        """One pivot; returns False when terminal."""
        r = self.reduced_costs()
        negative = r < -self.tol
        if not negative.any():
            self.status = "optimal"
            return False
        if self.pricing == "bland":
            enter = int(np.argmax(negative))
        else:
            enter = int(np.argmin(r))
        d = self.inv_B @ self.A[:, enter]
        pos = d > self.tol
        if not pos.any():
            self.status = "unbounded"
            return False
        theta = np.where(pos, self.x_B / np.where(pos, d, 1.0), np.inf)
        leave = int(np.argmin(theta))
        # rank-1 product-form update
        u = -d / d[leave]
        u[leave] = 1.0 / d[leave] - 1.0
        self.inv_B += np.outer(u, self.inv_B[leave])
        self.x_B += u * self.x_B[leave]
        self.basis[leave] = enter
        self.trace.append((enter, leave))
        self.basis_trace.append(self.basis.copy())
        return True

    def dual_step(self) -> bool:
        """One dual-simplex pivot; returns False when terminal."""
        neg = self.x_B < -self.tol
        if not neg.any():
            self.status = "optimal"
            return False
        if self.pricing == "bland":
            leave = int(np.argmax(neg))
        else:  # dantzig: most infeasible basic variable
            leave = int(np.argmin(self.x_B))
        u = self.inv_B[leave] @ self.A
        u[self.basis] = 0.0
        cand = u < -self.tol
        if not cand.any():
            self.status = "dual_unbounded"
            return False
        r = self.reduced_costs()
        theta = np.where(cand, -r / np.where(cand, u, -1.0), np.inf)
        enter = int(np.argmin(theta))
        d = self.inv_B @ self.A[:, enter]
        w = -d / d[leave]
        w[leave] = 1.0 / d[leave] - 1.0
        self.inv_B += np.outer(w, self.inv_B[leave])
        self.x_B += w * self.x_B[leave]
        self.basis[leave] = enter
        self.trace.append((enter, leave))
        self.basis_trace.append(self.basis.copy())
        return True

    def solve(self, maxiters: int = 10_000, mode: str = "primal"):
        step = self.step if mode == "primal" else self.dual_step
        for _ in range(maxiters):
            if not step():
                break
        else:
            self.status = "iter_limit"
        return self

    @property
    def x(self) -> np.ndarray:
        out = np.zeros(self.c.shape[0])
        out[self.basis] = self.x_B
        return out

    @property
    def cost(self) -> float:
        return float(self.c @ self.x)


def oracle_solve(c, A, b, basis, pricing: str = "bland", maxiters: int = 10_000):
    return OracleSimplex(c, A, b, basis, pricing=pricing).solve(maxiters)
