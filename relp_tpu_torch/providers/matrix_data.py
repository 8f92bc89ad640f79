"""Standard-form provider over a standardized GeneralForm.

Mirror of reference ``matrix_provider/matrix_data.rs``: a virtual 6-group
column layout over the GeneralForm's data, synthesizing ±1 slack columns on
the fly and exposing slack pivots as a partial initial basis.

Row layout (reference: matrix_data.rs:46-61)::

    0 ..                                    nr_eq   : equality rows
    .. + nr_range                                   : range rows
    .. + nr_upper                                   : <= rows
    .. + nr_lower                                   : >= rows
    .. + nr_bounded_variables                       : variable bound rows (x_j + s = u_j)
    .. + nr_range                                   : slack bound rows (s_range + s' = r)

Column layout::

    normal | range slacks | <= slacks | >= slacks (-1) | var-bound slacks | slack-bound slacks

Right-hand side: [b ; u ; r] — all nonnegative after standardization.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple

from relp_tpu_torch.data.elements import BoundDirection
from relp_tpu_torch.data.general_form import Variable
from relp_tpu_torch.linalg.sparse import SparseColumnMatrix, SparseVector
from relp_tpu_torch.providers.base import PartialInitialBasis
from relp_tpu_torch.providers.column import (
    Column,
    MINUS_ONE,
    ONE,
    SlackColumn,
    SparseColumn,
    TwoSlackColumn,
)


class MatrixData(PartialInitialBasis):
    def __init__(
        self,
        constraints: SparseColumnMatrix,
        b: List[Fraction],
        ranges: List[Fraction],
        nr_equality: int,
        nr_range: int,
        nr_upper: int,
        nr_lower: int,
        variables: List[Variable],
    ):
        assert all(v.lower_bound == 0 and v.shift is not None for v in variables)
        self.constraints = constraints
        self.b = b
        self.ranges = ranges
        self.nr_equality = nr_equality
        self.nr_range = nr_range
        self.nr_upper = nr_upper
        self.nr_lower = nr_lower
        self.variables = variables

        # Bounded-variable bookkeeping (matrix_data.rs:63-102).
        self.bound_index_to_variable: List[int] = [
            j for j, v in enumerate(variables) if v.upper_bound is not None
        ]
        self.variable_to_bound_index: List[Optional[int]] = [None] * len(variables)
        for bound_idx, j in enumerate(self.bound_index_to_variable):
            self.variable_to_bound_index[j] = bound_idx

        nr_bounds = len(self.bound_index_to_variable)
        # Row group ends.
        self.row_end_eq = nr_equality
        self.row_end_range = self.row_end_eq + nr_range
        self.row_end_upper = self.row_end_range + nr_upper
        self.row_end_lower = self.row_end_upper + nr_lower
        self.row_end_varbound = self.row_end_lower + nr_bounds
        self.row_end_slackbound = self.row_end_varbound + nr_range

        # Column group ends.
        n = len(variables)
        self.col_end_normal = n
        self.col_end_rangeslack = n + nr_range
        self.col_end_upperslack = self.col_end_rangeslack + nr_upper
        self.col_end_lowerslack = self.col_end_upperslack + nr_lower
        self.col_end_varboundslack = self.col_end_lowerslack + nr_bounds
        self.col_end_slackboundslack = self.col_end_varboundslack + nr_range

    # --- provider surface ---

    def column(self, j: int) -> Column:
        assert 0 <= j < self.nr_columns()
        if j < self.col_end_normal:
            entries = list(self.constraints.iter_column(j))
            bound_row = self.bound_row_index(j, BoundDirection.UPPER)
            if bound_row is not None:
                entries.append((bound_row, ONE))
            return SparseColumn(entries)
        if j < self.col_end_rangeslack:
            k = j - self.col_end_normal
            return TwoSlackColumn(self.row_end_eq + k, self.row_end_varbound + k)
        if j < self.col_end_upperslack:
            k = j - self.col_end_rangeslack
            return SlackColumn(self.row_end_range + k, ONE)
        if j < self.col_end_lowerslack:
            k = j - self.col_end_upperslack
            return SlackColumn(self.row_end_upper + k, MINUS_ONE)
        if j < self.col_end_varboundslack:
            k = j - self.col_end_lowerslack
            return SlackColumn(self.row_end_lower + k, ONE)
        k = j - self.col_end_varboundslack
        return SlackColumn(self.row_end_varbound + k, ONE)

    def cost_value(self, j: int) -> Fraction:
        assert 0 <= j < self.nr_columns()
        if j < self.col_end_normal:
            return self.variables[j].cost
        return Fraction(0)

    def right_hand_side(self) -> List[Fraction]:
        values = list(self.b)
        values.extend(
            self.variables[j].upper_bound  # type: ignore[arg-type]
            for j in self.bound_index_to_variable
        )
        values.extend(self.ranges)
        return values

    def bound_row_index(self, j: int, direction: BoundDirection) -> Optional[int]:
        assert 0 <= j < self.nr_columns()
        if direction is BoundDirection.LOWER:
            return None
        if j < self.col_end_normal:
            bound_idx = self.variable_to_bound_index[j]
            if bound_idx is None:
                return None
            return self.row_end_lower + bound_idx
        if j < self.col_end_rangeslack:
            return self.row_end_varbound + (j - self.col_end_normal)
        return None

    def nr_constraints(self) -> int:
        return self.row_end_lower

    def nr_variable_bounds(self) -> int:
        return len(self.bound_index_to_variable) + self.nr_range

    def nr_columns(self) -> int:
        return self.col_end_slackboundslack

    def nr_normal_variables(self) -> int:
        return self.col_end_normal

    def reconstruct_solution(self, column_values: SparseVector) -> SparseVector:
        """Drop all slack groups (matrix_data.rs:402-411)."""
        assert column_values.length == self.nr_columns()
        entries = [(i, v) for i, v in column_values if i < self.col_end_normal]
        return SparseVector(entries, self.col_end_normal, _trusted=True)

    # --- partial initial basis (matrix_data.rs:419-450) ---

    def pivot_element_indices(self) -> List[Tuple[int, int]]:
        pairs: List[Tuple[int, int]] = []
        for k in range(self.nr_upper):
            pairs.append((self.row_end_range + k, self.col_end_rangeslack + k))
        for k in range(len(self.bound_index_to_variable)):
            pairs.append((self.row_end_lower + k, self.col_end_lowerslack + k))
        for k in range(self.nr_range):
            pairs.append((self.row_end_varbound + k, self.col_end_varboundslack + k))
        return pairs

    def nr_initial_elements(self) -> int:
        return self.nr_upper + self.nr_variable_bounds()

    def __repr__(self) -> str:
        return (
            f"MatrixData(rows={self.nr_rows()}, columns={self.nr_columns()}, "
            f"eq={self.nr_equality}, range={self.nr_range}, le={self.nr_upper}, "
            f"ge={self.nr_lower}, bounds={len(self.bound_index_to_variable)})"
        )
