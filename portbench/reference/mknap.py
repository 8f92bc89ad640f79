"""The knapsack as the reference sees it, from the raw instance alone: its
LP relaxation and the exact check of a point or an incumbent."""

from __future__ import annotations

from fractions import Fraction
from typing import Dict

from portbench.reference import lp as ref


def relaxation(W, capacity, profit) -> ref.LP:
    """minimise -profit.x subject to W x <= capacity, 0 <= x <= 1, in
    standard form: the n items, then a slack a knapsack row, then a slack
    an upper bound."""
    m, n = W.shape
    columns = [[(i, int(W[i, j])) for i in range(m) if W[i, j]] + [(m + j, 1)]
               for j in range(n)]
    columns += [[(i, 1)] for i in range(m)] + [[(m + j, 1)] for j in range(n)]
    b = [int(v) for v in capacity] + [1] * n
    c = [-int(p) for p in profit] + [0] * (m + n)
    return ref.LP(columns, b, c)


def point_holds(W, capacity, profit, values: Dict[str, Fraction],
                objective: Fraction, integer: bool = True) -> bool:
    """Whether the named values lie in [0, 1] (with ``integer``, are 0 or
    1), fit every knapsack row exactly, and give ``objective`` (the
    minimise sense: -profit.x)."""
    m, n = W.shape
    x = [Fraction(values.get(f"x{j}", 0)) for j in range(n)]
    if any(not (0 <= v <= 1) or (integer and v not in (0, 1)) for v in x):
        return False
    if any(sum(int(W[i, j]) * x[j] for j in range(n)) > int(capacity[i])
           for i in range(m)):
        return False
    return -sum(int(profit[j]) * x[j] for j in range(n)) == objective
