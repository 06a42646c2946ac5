"""Scenario analysis: solve thousands of perturbed LPs in one device batch.

The north-star batched use case: take a base model (here the SAS diet LP),
generate thousands of scenarios (perturbed prices), and solve them all in a
single compiled two-phase computation on the device -- then reduce the results
on-device.  The reference library would loop this one solve at a time.

Run: python examples/scenario_batch.py [num_scenarios]
"""

import sys

import numpy as np

import jax
import jax.numpy as jnp

from linprog_tpu.batch import batch_summary, solve_batch_two_phase
from linprog_tpu.config import SolverConfig
from linprog_tpu.forms import bounds_to_rows, canonical_to_standard
from examples.diet import G, costs, h, lb, ub


def build_scenarios(num: int, seed: int = 0):
    """Perturb food prices +/-20% per scenario; constraints stay fixed."""
    rng = np.random.default_rng(seed)
    price_mult = rng.uniform(0.8, 1.2, size=(num, costs.shape[0]))
    cs, As, bs = [], [], []
    for k in range(num):
        c_std, A_std, b_std = canonical_to_standard(
            costs * price_mult[k], G, h
        )
        c_k, A_k, b_k = bounds_to_rows(c_std, A_std, b_std,
                                       np.concatenate([lb, np.zeros(G.shape[0])]),
                                       np.concatenate([ub, np.full(G.shape[0], np.inf)]))
        cs.append(c_k)
        As.append(A_k)
        bs.append(b_k)
    return (
        jnp.asarray(np.stack(cs)),
        jnp.asarray(np.stack(As)),
        jnp.asarray(np.stack(bs)),
        price_mult,
    )


def main():
    num = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    cs, As, bs, mult = build_scenarios(num)
    cfg = SolverConfig(pricing="dantzig", refactor_every=64)
    res = solve_batch_two_phase(cs, As, bs, 500, 500, cfg)
    summary = batch_summary(res)
    cost = np.asarray(res.cost)

    print(f"scenarios: {num}  ->  {summary}")
    print(f"diet cost: mean={cost.mean():.4f}  min={cost.min():.4f}  "
          f"max={cost.max():.4f}  std={cost.std():.4f}")
    # which scenario makes the diet cheapest?
    best = int(np.argmin(cost))
    print(f"cheapest scenario #{best}: price multipliers {mult[best].round(3)}")


if __name__ == "__main__":
    main()
