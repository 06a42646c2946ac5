"""MPS writer: serialize LP problems to the (fixed-ish free-form) MPS format.

Counterpart of the native reader (``native/mps_reader.cpp``) -- the
reference library has neither reader nor writer; together they let the
framework interoperate with every standard LP toolchain, and they power the
structured-instance acceptance suite (``tests/test_structured_suite.py``)
which round-trips generated instances through the parser before solving.

Accepted problem form mirrors ``SimplexSolver``/``mps_to_solver_inputs``:
``min c'x  s.t.  A x = b,  G x <= h,  lb <= x <= ub``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _fmt(v: float) -> str:
    return f"{float(v):.12g}"


def write_mps(
    path: str,
    c,
    A=None,
    b=None,
    G=None,
    h=None,
    lb=None,
    ub=None,
    name: str = "LP",
    maximize: bool = False,
) -> None:
    """Write the LP to ``path`` in MPS format.

    Zeros of ``A``/``G`` are skipped (sparse COLUMNS section).  Finite
    bounds become a BOUNDS section (``LO``/``UP``/``FX``/``MI``); the MPS
    default bound ``0 <= x < inf`` is emitted implicitly.
    """
    c = np.asarray(c, np.float64)
    n = c.shape[0]
    A = None if A is None else np.atleast_2d(np.asarray(A, np.float64))
    G = None if G is None else np.atleast_2d(np.asarray(G, np.float64))
    b = None if b is None else np.asarray(b, np.float64)
    h = None if h is None else np.asarray(h, np.float64)
    lb_arr: Optional[np.ndarray] = (
        None if lb is None else np.asarray(lb, np.float64)
    )
    ub_arr: Optional[np.ndarray] = (
        None if ub is None else np.asarray(ub, np.float64)
    )

    rows = []  # (type, name, coeff_row, rhs)
    if A is not None:
        for i in range(A.shape[0]):
            rows.append(("E", f"EQ{i}", A[i], float(b[i])))
    if G is not None:
        for i in range(G.shape[0]):
            rows.append(("L", f"LE{i}", G[i], float(h[i])))

    lines = [f"NAME          {name}"]
    if maximize:
        lines += ["OBJSENSE", "    MAX"]
    lines.append("ROWS")
    lines.append(" N  OBJ")
    for t, rname, _, _ in rows:
        lines.append(f" {t}  {rname}")

    lines.append("COLUMNS")
    for j in range(n):
        col = f"X{j}"
        entries = []
        if c[j] != 0.0:
            entries.append(("OBJ", c[j]))
        for t, rname, coeffs, _ in rows:
            if coeffs[j] != 0.0:
                entries.append((rname, coeffs[j]))
        for k in range(0, len(entries), 2):
            pair = entries[k : k + 2]
            parts = "   ".join(f"{rn:<10}{_fmt(v):>14}" for rn, v in pair)
            lines.append(f"    {col:<10}{parts}")

    lines.append("RHS")
    rhs_entries = [
        (rname, rhs) for _, rname, _, rhs in rows if rhs != 0.0
    ]
    for k in range(0, len(rhs_entries), 2):
        pair = rhs_entries[k : k + 2]
        parts = "   ".join(f"{rn:<10}{_fmt(v):>14}" for rn, v in pair)
        lines.append(f"    RHS       {parts}")

    bound_lines = []
    for j in range(n):
        lo = 0.0 if lb_arr is None else float(lb_arr[j])
        hi = np.inf if ub_arr is None else float(ub_arr[j])
        col = f"X{j}"
        if lo == hi:
            bound_lines.append(f" FX BND       {col:<10}{_fmt(lo):>14}")
            continue
        if np.isneginf(lo):
            bound_lines.append(f" MI BND       {col:<10}")
        elif lo != 0.0:
            bound_lines.append(f" LO BND       {col:<10}{_fmt(lo):>14}")
        if np.isfinite(hi):
            bound_lines.append(f" UP BND       {col:<10}{_fmt(hi):>14}")
    if bound_lines:
        lines.append("BOUNDS")
        lines.extend(bound_lines)

    lines.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
