"""Row filtering — rank repair after phase 1.

Mirror of reference ``matrix_provider/filter/generic_wrapper.rs``: a wrapper
presenting a provider minus redundant rows discovered during phase 1
(linearly dependent constraints), with index remapping on every access.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Sequence

from relp_tpu_torch.data.elements import BoundDirection
from relp_tpu_torch.linalg.sparse import SparseVector
from relp_tpu_torch.providers.base import MatrixProvider, PartialInitialBasis
from relp_tpu_torch.providers.column import Column


class RemoveRows(PartialInitialBasis):
    """Provider view with some rows removed (reference: RemoveRows).

    Subclasses :class:`PartialInitialBasis` so the lowering keeps the
    surviving slack pivots (remapped); with a non-partial inner provider
    it simply offers none."""

    def __init__(self, inner: MatrixProvider, rows_to_skip: Sequence[int]):
        self.inner = inner
        self.rows_to_skip = sorted(set(rows_to_skip))
        assert all(0 <= r < inner.nr_rows() for r in self.rows_to_skip)
        # old row -> new row (-1 for removed), and its inverse.
        self._old_to_new: List[int] = []
        self._new_to_old: List[int] = []
        skip = set(self.rows_to_skip)
        for i in range(inner.nr_rows()):
            if i in skip:
                self._old_to_new.append(-1)
            else:
                self._old_to_new.append(len(self._new_to_old))
                self._new_to_old.append(i)

    def nr_constraints(self) -> int:
        removed_constraints = sum(
            1 for r in self.rows_to_skip if r < self.inner.nr_constraints()
        )
        return self.inner.nr_constraints() - removed_constraints

    def nr_variable_bounds(self) -> int:
        removed_bounds = sum(
            1 for r in self.rows_to_skip if r >= self.inner.nr_constraints()
        )
        return self.inner.nr_variable_bounds() - removed_bounds

    def nr_columns(self) -> int:
        return self.inner.nr_columns()

    def column(self, j: int) -> Column:
        return self.inner.column(j).removing_rows(self._old_to_new)

    def cost_value(self, j: int) -> Fraction:
        return self.inner.cost_value(j)

    def right_hand_side(self) -> List[Fraction]:
        rhs = self.inner.right_hand_side()
        return [rhs[i] for i in self._new_to_old]

    def bound_row_index(self, j: int, direction: BoundDirection) -> Optional[int]:
        old = self.inner.bound_row_index(j, direction)
        if old is None:
            return None
        new = self._old_to_new[old]
        return new if new >= 0 else None

    def pivot_element_indices(self) -> List[tuple]:
        if not isinstance(self.inner, PartialInitialBasis):
            return []
        out = []
        for row, col in self.inner.pivot_element_indices():
            new = self._old_to_new[row]
            if new >= 0:
                out.append((new, col))
        return out

    def reconstruct_solution(self, column_values: SparseVector) -> SparseVector:
        return self.inner.reconstruct_solution(column_values)
