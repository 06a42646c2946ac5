"""Structured LP instance generators (netlib-style validation suite).

The iid-gaussian bench distribution is isotropic and non-degenerate --
exactly the regime where Dantzig pricing is near-optimal and nothing
interesting happens numerically.  Real LPs (and the netlib set, which a
zero-egress sandbox cannot download) are sparse, degenerate, and badly
scaled.  These generators produce classic structured families with those
properties; ``tests/test_structured_suite.py`` round-trips them through the MPS
writer/reader and validate objectives against the HiGHS oracle.

Reference analogue: its textbook problem bank
(``/root/reference/tests/problems.py:18-167``) and the transportation
generator it ships but never uses (``/root/reference/tests/utils.py:4-41``).

Every generator returns a dict with keys
``name, c, A, b, G, h, lb, ub`` in the ``SimplexSolver`` general form
``min c'x  s.t.  A x = b,  G x <= h,  lb <= x <= ub`` (entries may be None).
"""

from __future__ import annotations

import numpy as np


def _prob(name, c, A=None, b=None, G=None, h=None, lb=None, ub=None):
    return {
        "name": name, "c": c, "A": A, "b": b, "G": G, "h": h,
        "lb": lb, "ub": ub,
    }


def transportation(ns: int, nd: int, seed: int = 0, integral: bool = True):
    """Balanced transportation problem: ns supplies x nd demands.

    Highly degenerate when supplies/demands are integral (the classic
    simplex stress case).  Variables x[i,j] flattened row-major.
    """
    rng = np.random.default_rng(seed)
    supply = rng.integers(5, 20, ns).astype(np.float64)
    demand = rng.multinomial(
        int(supply.sum()) - nd, np.full(nd, 1.0 / nd)
    ).astype(np.float64) + 1.0
    if not integral:
        jitter = rng.uniform(-0.25, 0.25, nd)
        demand += jitter - jitter.mean()
    cost = rng.integers(1, 10, (ns, nd)).astype(np.float64)
    n = ns * nd
    A = np.zeros((ns + nd, n))
    for i in range(ns):
        A[i, i * nd : (i + 1) * nd] = 1.0
    for j in range(nd):
        A[ns + j, j::nd] = 1.0
    b = np.concatenate([supply, demand])
    # one balance row is redundant -- keep it: exercises the Phase-I
    # redundant-row handling (reference special_solvers.py:82-89)
    return _prob(f"transp_{ns}x{nd}_s{seed}", cost.ravel(), A=A, b=b)


def assignment(k: int, seed: int = 0):
    """k x k assignment LP relaxation (integral optimum, maximally
    degenerate: every basic feasible solution has k-1 zero basics)."""
    rng = np.random.default_rng(seed + 1)
    cost = rng.integers(1, 20, (k, k)).astype(np.float64)
    n = k * k
    A = np.zeros((2 * k, n))
    for i in range(k):
        A[i, i * k : (i + 1) * k] = 1.0
    for j in range(k):
        A[k + j, j::k] = 1.0
    b = np.ones(2 * k)
    return _prob(f"assign_{k}_s{seed}", cost.ravel(), A=A, b=b)


def production_planning(T: int = 12, seed: int = 0):
    """Staircase multi-period production/inventory LP.

    Variables per period: production p_t (cost c_t, capacity cap) and
    inventory i_t (holding cost).  Balance: p_t + i_{t-1} - i_t = d_t.
    """
    rng = np.random.default_rng(seed)
    demand = rng.integers(4, 12, T).astype(np.float64)
    pcost = rng.uniform(1.0, 3.0, T)
    hold = rng.uniform(0.05, 0.3, T)
    cap = float(demand.mean() * 1.5)
    n = 2 * T  # [p_0..p_{T-1}, i_0..i_{T-1}]
    c = np.concatenate([pcost, hold])
    A = np.zeros((T, n))
    for t in range(T):
        A[t, t] = 1.0  # p_t
        A[t, T + t] = -1.0  # -i_t
        if t > 0:
            A[t, T + t - 1] = 1.0  # +i_{t-1}
    b = demand
    ub = np.concatenate([np.full(T, cap), np.full(T, np.inf)])
    return _prob(f"prodplan_{T}_s{seed}", c, A=A, b=b, ub=ub)


def blending(n_mat: int = 20, n_spec: int = 8, seed: int = 0):
    """Diet/blending LP: meet n_spec nutrient minima from n_mat materials
    at minimum cost, with per-material availability caps (SAS diet problem
    writ large -- reference examples/diet.py is the 6x4 instance)."""
    rng = np.random.default_rng(seed)
    N = rng.uniform(0.0, 10.0, (n_spec, n_mat))
    N *= rng.random((n_spec, n_mat)) < 0.6  # sparsity
    req = N.mean(axis=1) * n_mat * 0.3 + 1.0
    cost = rng.uniform(1.0, 8.0, n_mat)
    ub = rng.uniform(1.0, 4.0, n_mat)
    # -N x <= -req  (nutrient minima)
    return _prob(
        f"blend_{n_mat}x{n_spec}_s{seed}", cost, G=-N, h=-req, ub=ub
    )


def min_cost_flow_grid(rows: int = 4, cols: int = 5, seed: int = 0):
    """Min-cost flow on a directed grid: source at (0,0), sink at the
    opposite corner, right/down arcs with random costs and capacities."""
    rng = np.random.default_rng(seed)
    nodes = [(r, c) for r in range(rows) for c in range(cols)]
    idx = {v: i for i, v in enumerate(nodes)}
    arcs = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                arcs.append(((r, c), (r, c + 1)))
            if r + 1 < rows:
                arcs.append(((r, c), (r + 1, c)))
    n = len(arcs)
    cost = rng.integers(1, 9, n).astype(np.float64)
    cap = rng.integers(2, 6, n).astype(np.float64)
    flow = 4.0
    A = np.zeros((len(nodes), n))
    for a, (u, v) in enumerate(arcs):
        A[idx[u], a] = 1.0
        A[idx[v], a] = -1.0
    bvec = np.zeros(len(nodes))
    bvec[idx[(0, 0)]] = flow
    bvec[idx[(rows - 1, cols - 1)]] = -flow
    return _prob(
        f"flow_{rows}x{cols}_s{seed}", cost, A=A, b=bvec, ub=cap
    )


def chebyshev_center(m: int = 30, n: int = 8, seed: int = 0):
    """Chebyshev center of a random polytope: max r s.t.
    a_i'x + ||a_i|| r <= b_i  -- dense rows with very uneven scaling."""
    rng = np.random.default_rng(seed)
    Araw = rng.standard_normal((m, n)) * rng.lognormal(0, 1.0, (m, 1))
    bvec = np.abs(rng.standard_normal(m)) * np.linalg.norm(Araw, axis=1) + 1.0
    norms = np.linalg.norm(Araw, axis=1)
    G = np.concatenate([Araw, norms[:, None]], axis=1)
    c = np.zeros(n + 1)
    c[-1] = -1.0  # maximize r
    lb = np.concatenate([np.full(n, -np.inf), [0.0]])
    return _prob(f"cheb_{m}x{n}_s{seed}", c, G=G, h=bvec, lb=lb)


def set_covering(n_elems: int = 30, n_sets: int = 12, seed: int = 0):
    """LP relaxation of set covering: min 1'x, sum_{j covers e} x_j >= 1."""
    rng = np.random.default_rng(seed)
    C = (rng.random((n_elems, n_sets)) < 0.3).astype(np.float64)
    C[np.arange(n_elems), rng.integers(0, n_sets, n_elems)] = 1.0  # coverable
    cost = rng.uniform(1.0, 5.0, n_sets)
    return _prob(
        f"cover_{n_elems}x{n_sets}_s{seed}", cost, G=-C,
        h=-np.ones(n_elems), ub=np.ones(n_sets),
    )


def sas_diet():
    """The reference's own acceptance instance (examples/diet.py data)."""
    costs = np.array([2.0, 3.5, 8.0, 1.5, 11.0, 1.0])
    protein = np.array([4.0, 8.0, 7.0, 1.3, 8.0, 9.2])
    fat = np.array([1.0, 5.0, 9.0, 0.1, 7.0, 1.0])
    carbs = np.array([15.0, 11.7, 0.4, 22.6, 0.0, 17.0])
    cals = np.array([0.90, 12, 10.6, 9.7, 13, 18])
    G = np.stack([-cals, -protein, fat, carbs])
    h = np.array([-30.0, -10.0, 8.0, 40.0])
    lb = np.array([0.0, 0.0, 0.0, 0.0, 0.5, 0.0])
    ub = np.array([np.inf, 1.0, np.inf, np.inf, np.inf, np.inf])
    return _prob("sas_diet", costs, G=G, h=h, lb=lb, ub=ub)


def staff_scheduling(days: int = 14, shift_len: int = 5, seed: int = 0):
    """Cyclic staffing LP: one shift starts each day and covers the next
    ``shift_len`` days (mod ``days``); meet daily demand at minimum staff.
    Circulant covering structure, typically fractional + degenerate."""
    rng = np.random.default_rng(seed)
    demand = rng.integers(3, 12, days).astype(np.float64)
    G = np.zeros((days, days))
    for s in range(days):
        for d in range(shift_len):
            G[(s + d) % days, s] = 1.0
    # coverage >= demand  ->  -G x <= -demand
    return _prob(
        f"staff_{days}d{shift_len}_s{seed}",
        np.ones(days), G=-G, h=-demand,
    )


def multicommodity_flow_grid(rows: int = 3, cols: int = 4, seed: int = 0):
    """Two commodities share arc capacities on a directed grid: per-
    commodity flow conservation (equalities) + joint capacity rows
    (inequalities) -- the classic block-angular structure."""
    rng = np.random.default_rng(seed)
    nodes = [(r, c) for r in range(rows) for c in range(cols)]
    idx = {v: i for i, v in enumerate(nodes)}
    arcs = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                arcs.append(((r, c), (r, c + 1)))
            if r + 1 < rows:
                arcs.append(((r, c), (r + 1, c)))
    na, nn = len(arcs), len(nodes)
    inc = np.zeros((nn, na))
    for a, (u, v) in enumerate(arcs):
        inc[idx[u], a] = 1.0
        inc[idx[v], a] = -1.0
    # two commodities with distinct sources, both draining to the far
    # corner (the only sink every source reaches on a down/right grid);
    # they contend for the shared arc capacities near the sink
    b1 = np.zeros(nn)
    b1[idx[(0, 0)]] = 2.0
    b1[idx[(rows - 1, cols - 1)]] = -2.0
    b2 = np.zeros(nn)
    b2[idx[(0, cols - 2)]] = 2.0
    b2[idx[(rows - 1, cols - 1)]] = -2.0
    A = np.block([
        [inc, np.zeros((nn, na))],
        [np.zeros((nn, na)), inc],
    ])
    b = np.concatenate([b1, b2])
    cap = rng.integers(3, 6, na).astype(np.float64)
    G = np.concatenate([np.eye(na), np.eye(na)], axis=1)  # joint capacity
    cost = np.concatenate([
        rng.integers(1, 9, na), rng.integers(1, 9, na)
    ]).astype(np.float64)
    return _prob(
        f"mcflow_{rows}x{cols}_s{seed}", cost, A=A, b=b, G=G, h=cap,
    )


def knapsack_relaxation(n_items: int = 24, n_knap: int = 3, seed: int = 0):
    """LP relaxation of the multi-knapsack problem: maximize value under
    several weight budgets with 0 <= x <= 1 (generalized-upper-bound
    structure; optima sit on fractional vertices)."""
    rng = np.random.default_rng(seed)
    value = rng.uniform(1.0, 10.0, n_items)
    W = rng.uniform(1.0, 6.0, (n_knap, n_items))
    cap = W.sum(axis=1) * 0.4
    return _prob(
        f"knap_{n_items}x{n_knap}_s{seed}",
        -value, G=W, h=cap, ub=np.ones(n_items),
    )


def default_suite():
    """The committed 15-instance acceptance suite."""
    return [
        transportation(5, 7, seed=0),
        transportation(10, 15, seed=1),
        transportation(8, 8, seed=2, integral=False),
        assignment(6, seed=0),
        assignment(10, seed=3),
        production_planning(12, seed=0),
        production_planning(24, seed=4),
        blending(20, 8, seed=0),
        min_cost_flow_grid(4, 5, seed=0),
        chebyshev_center(30, 8, seed=0),
        set_covering(30, 12, seed=0),
        staff_scheduling(14, 5, seed=0),
        multicommodity_flow_grid(3, 4, seed=0),
        knapsack_relaxation(24, 3, seed=0),
        sas_diet(),
    ]
