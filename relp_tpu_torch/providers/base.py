"""The MatrixProvider abstraction.

Mirror of reference ``matrix_provider/mod.rs:37-134``: a read-only virtual
standard-form LP — ``column(j)``, ``cost_value(j)``, ``right_hand_side()``,
``bound_row_index``, counts, and ``reconstruct_solution``.  Any object (graph,
generator, shard server) can be a provider; columns need never exist as one
big matrix on the host.

TPU addition: :meth:`to_arrays` lowers the provider to dense float arrays
(optionally a column sub-range for sharded lowering).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np

from relp_tpu_torch.data.elements import BoundDirection
from relp_tpu_torch.linalg.sparse import SparseVector
from relp_tpu_torch.providers.column import Column


class MatrixProvider:
    """Read-only standard-form LP view (all rows are equalities after adding
    the provider's virtual slacks; rhs is nonnegative)."""

    # --- the virtual-matrix surface (reference trait methods) ---

    def column(self, j: int) -> Column:
        raise NotImplementedError

    def cost_value(self, j: int) -> Fraction:
        raise NotImplementedError

    def right_hand_side(self) -> List[Fraction]:
        raise NotImplementedError

    def bound_row_index(self, j: int, direction: BoundDirection) -> Optional[int]:
        """Row expressing a simple bound on column ``j`` (or None)."""
        raise NotImplementedError

    def nr_constraints(self) -> int:
        """Rows that come from real constraints (not bounds)."""
        raise NotImplementedError

    def nr_variable_bounds(self) -> int:
        """Rows that express variable/slack bounds."""
        raise NotImplementedError

    def nr_rows(self) -> int:
        return self.nr_constraints() + self.nr_variable_bounds()

    def nr_columns(self) -> int:
        raise NotImplementedError

    def reconstruct_solution(self, column_values: SparseVector) -> SparseVector:
        """Strip provider-synthesized (slack) columns from a BFS."""
        raise NotImplementedError

    # --- TPU lowering ---

    def to_arrays(
        self,
        dtype=np.float64,
        column_range: Optional[Tuple[int, int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialize (A, b, c) as dense float arrays.

        ``column_range=(lo, hi)`` lowers only columns [lo, hi) — the unit of
        work for column-sharded lowering across a device mesh.
        """
        lo, hi = column_range if column_range is not None else (0, self.nr_columns())
        m = self.nr_rows()
        A = np.zeros((m, hi - lo), dtype=dtype)
        c = np.zeros(hi - lo, dtype=dtype)
        for j in range(lo, hi):
            for i, v in self.column(j).iter_entries():
                A[i, j - lo] = float(v)
            c[j - lo] = float(self.cost_value(j))
        b = np.array([float(v) for v in self.right_hand_side()], dtype=dtype)
        return A, b, c

    # --- exact data access for the certifier ---

    def exact_column_entries(self, j: int) -> List[Tuple[int, Fraction]]:
        return self.column(j).entries()


class PartialInitialBasis(MatrixProvider):
    """Provider that can supply part of an initial basis from its slacks
    (reference: PartialInitialBasis trait, matrix_data.rs:419-450)."""

    def pivot_element_indices(self) -> List[Tuple[int, int]]:
        """(row, column) pairs with a +1 usable as an initial pivot."""
        raise NotImplementedError

    def nr_initial_elements(self) -> int:
        return len(self.pivot_element_indices())


class FullInitialBasis(PartialInitialBasis):
    """Marker: the initial pivots cover every row — phase 1 can be skipped
    (reference: FullInitialBasis, two_phase/mod.rs:80-109)."""
