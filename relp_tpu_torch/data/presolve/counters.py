"""Presolve counters.

Mirror of reference ``presolve/counters.rs``: per-row and per-column live
nonzero counts, plus per-constraint "number of variable bounds missing to
compute an activity bound" counters (lower, upper), over a row-major copy of
the constraint matrix.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Iterator, List, Tuple

from relp_tpu_torch.data.elements import BoundDirection
from relp_tpu_torch.data.general_form import GeneralForm
from relp_tpu_torch.numbers.rational import sign


class Counters:
    def __init__(self, general_form: GeneralForm):
        gf = general_form
        n_rows = gf.nr_constraints()
        n_cols = gf.nr_variables()

        # Row-major and column-major adjacency (live entries filtered by the
        # alive flags at iteration time).
        self.row_entries: List[Dict[int, Fraction]] = [dict() for _ in range(n_rows)]
        self.col_entries: List[Dict[int, Fraction]] = [dict() for _ in range(n_cols)]
        for j, col in enumerate(gf.constraints.columns):
            for i, v in col:
                self.row_entries[i][j] = v
                self.col_entries[j][i] = v

        self.constraint: List[int] = [len(r) for r in self.row_entries]
        self.variable: List[int] = [len(c) for c in self.col_entries]

        # (missing-for-lower-activity, missing-for-upper-activity) per row.
        self.activity: List[List[int]] = []
        for i in range(n_rows):
            lower_missing = upper_missing = 0
            for j, coefficient in self.row_entries[i].items():
                var = gf.variables[j]
                lower, upper = var.lower_bound, var.upper_bound
                if sign(coefficient) < 0:
                    lower, upper = upper, lower
                lower_missing += lower is None
                upper_missing += upper is None
            self.activity.append([lower_missing, upper_missing])

    def is_constraint_still_active(self, i: int) -> bool:
        """Counter-based liveness (reference: counters.rs:127-129)."""
        return self.constraint[i] > 0

    def is_variable_still_active(self, j: int) -> bool:
        return self.variable[j] > 0

    def iter_active_row(self, i: int) -> Iterator[Tuple[int, Fraction]]:
        for j, v in self.row_entries[i].items():
            if self.variable[j] > 0:
                yield (j, v)

    def iter_active_column(self, j: int) -> Iterator[Tuple[int, Fraction]]:
        for i, v in self.col_entries[j].items():
            if self.constraint[i] > 0:
                yield (i, v)

    def activity_counter(self, i: int, direction: BoundDirection) -> int:
        return self.activity[i][0 if direction is BoundDirection.LOWER else 1]

    def add_to_activity_counter(self, i: int, direction: BoundDirection, delta: int) -> int:
        k = 0 if direction is BoundDirection.LOWER else 1
        self.activity[i][k] += delta
        return self.activity[i][k]
