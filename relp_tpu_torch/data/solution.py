"""Full solutions to linear programs.

Mirror of the reference's ``src/data/linear_program/solution.rs``: an exact
objective value plus (name, value) pairs for every original variable, with the
fuzzy-equality heuristic used to compare degenerate alternate optima.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import List, Tuple


@dataclass
class Solution:
    """An (exact) full solution: objective and per-variable values."""

    objective_value: Fraction
    solution_values: List[Tuple[str, Fraction]]

    def value_of(self, name: str) -> Fraction:
        for n, v in self.solution_values:
            if n == name:
                return v
        raise KeyError(name)

    def is_probably_equal_to(self, other: "Solution", min_equal: float) -> bool:
        """Heuristic equality for problems with multiple optima.

        Objectives must match exactly; for problems with >= 10 variables at
        least ``min_equal`` of the per-variable values must agree
        (reference: solution.rs:46-78).
        """
        if self.objective_value != other.objective_value:
            return False
        if len(self.solution_values) != len(other.solution_values):
            return False
        this_map = dict(self.solution_values)
        other_map = dict(other.solution_values)
        if len(this_map) != len(other_map) or set(this_map) != set(other_map):
            return False
        nr_total = len(self.solution_values)
        if nr_total < 10:
            return True
        nr_equal = sum(1 for k, v in this_map.items() if other_map[k] == v)
        return nr_equal / nr_total > min_equal

    def __str__(self) -> str:
        return f"Objective value: {self.objective_value}"
