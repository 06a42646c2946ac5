"""The SAS diet problem solved with the general-form solver.

Capability parity with reference ``examples/diet.py`` (same data, same
expected optimum: cost 12.0813376...).
ref: http://documentation.sas.com/doc/en/orcdc/14.2/ormpug/ormpug_lpsolver_examples01.htm
"""

import numpy as np

from linprog_tpu import SimplexSolver

foods = ("Bread", "Milk", "Cheese", "Potato", "Fish", "Yogurt")
costs = np.array([2.0, 3.5, 8.0, 1.5, 11.0, 1.0])
protein = np.array([4.0, 8.0, 7.0, 1.3, 8.0, 9.2])
fat = np.array([1.0, 5.0, 9.0, 0.1, 7.0, 1.0])
carbohydrates = np.array([15.0, 11.7, 0.4, 22.6, 0.0, 17.0])
calories = np.array([0.90, 12, 10.6, 9.7, 13, 18])  # divided by 10 throughout

min_calories = 30
max_protein = 10
min_carbohydrates = 10
min_fat = 8

G = np.vstack([-calories, protein, -carbohydrates, -fat])
h = np.array([-min_calories, max_protein, -min_carbohydrates, -min_fat])

lb = np.zeros(len(foods))
ub = np.full(len(foods), np.inf)
lb[4] = 0.5  # fish lower bound
ub[1] = 1.0  # milk upper bound

if __name__ == "__main__":
    solver = SimplexSolver(c=costs, G=G, h=h, lb=lb, ub=ub)
    res = solver.solve()
    print(f"\nOptimal Diet Cost: {res.cost}")
    print("-" * 40)
    print("Optimal Diet:")
    for food, quantity in zip(foods, res.x[: len(foods)]):
        print(f"{food}: {quantity}")
