"""Host-side exact sparse storage.

Mirror of the reference's ``src/data/linear_algebra``: sparse vectors are
sorted ``(index, value)`` tuple lists with binary-search access
(reference: vector/sparse.rs:29-35), and the constraint matrix is a
column-major list of such columns (reference: matrix.rs:23-77).  Values are
exact ``Fraction``s; zeros are never stored.

This layer only serves the host pipeline (parse/presolve/standardize) and the
exact certifier; the device path lowers to dense tiled arrays instead.
"""

from __future__ import annotations

import bisect
from fractions import Fraction
from typing import Iterable, Iterator, List, Sequence, Tuple

Entry = Tuple[int, Fraction]


class SparseVector:
    """Sorted sparse vector of exact rationals."""

    __slots__ = ("entries", "length")

    def __init__(self, entries: Iterable[Entry], length: int, *, _trusted: bool = False):
        if _trusted:
            self.entries: List[Entry] = list(entries)
        else:
            cleaned = [(int(i), Fraction(v)) for i, v in entries if v != 0]
            cleaned.sort(key=lambda t: t[0])
            for (i, _), (j, _) in zip(cleaned, cleaned[1:]):
                if i == j:
                    raise ValueError(f"duplicate index {i}")
            if cleaned and (cleaned[0][0] < 0 or cleaned[-1][0] >= length):
                raise ValueError("index out of range")
            self.entries = cleaned
        self.length = length

    @staticmethod
    def from_dense(values: Sequence[Fraction]) -> "SparseVector":
        return SparseVector(
            [(i, Fraction(v)) for i, v in enumerate(values) if v != 0],
            len(values),
            _trusted=True,
        )

    def to_dense(self) -> List[Fraction]:
        out = [Fraction(0)] * self.length
        for i, v in self.entries:
            out[i] = v
        return out

    def get(self, index: int) -> Fraction:
        pos = bisect.bisect_left(self.entries, index, key=lambda t: t[0])
        if pos < len(self.entries) and self.entries[pos][0] == index:
            return self.entries[pos][1]
        return Fraction(0)

    def set(self, index: int, value: Fraction) -> None:
        pos = bisect.bisect_left(self.entries, index, key=lambda t: t[0])
        present = pos < len(self.entries) and self.entries[pos][0] == index
        if value == 0:
            if present:
                del self.entries[pos]
        elif present:
            self.entries[pos] = (index, value)
        else:
            self.entries.insert(pos, (index, value))

    def inner_product(self, other: "SparseVector") -> Fraction:
        """Merge-join inner product (reference: sparse.rs:105-111)."""
        total = Fraction(0)
        a, b = self.entries, other.entries
        ia = ib = 0
        while ia < len(a) and ib < len(b):
            i, j = a[ia][0], b[ib][0]
            if i == j:
                total += a[ia][1] * b[ib][1]
                ia += 1
                ib += 1
            elif i < j:
                ia += 1
            else:
                ib += 1
        return total

    def remove_indices(self, indices: Sequence[int]) -> None:
        """Drop the given (sorted) indices and shift the rest down.

        Mirrors ``Vector::remove_indices`` used by RemoveRows
        (reference: vector/mod.rs).
        """
        removed = sorted(set(indices))
        if not removed:
            return
        out: List[Entry] = []
        k = 0
        removed_set = set(removed)
        for i, v in self.entries:
            while k < len(removed) and removed[k] < i:
                k += 1
            if i in removed_set:
                continue
            out.append((i - k, v))
        self.entries = out
        self.length -= len(removed)

    def scale(self, factor: Fraction) -> None:
        if factor == 0:
            self.entries = []
        else:
            self.entries = [(i, v * factor) for i, v in self.entries]

    def __iter__(self) -> Iterator[Entry]:
        return iter(self.entries)

    def __len__(self) -> int:
        return self.length

    def nnz(self) -> int:
        return len(self.entries)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, SparseVector)
            and self.length == other.length
            and self.entries == other.entries
        )

    def __repr__(self) -> str:
        return f"SparseVector({self.entries!r}, length={self.length})"


class SparseColumnMatrix:
    """Column-major exact sparse matrix (reference: ColumnMajor SparseMatrix).

    ``columns[j]`` is a sorted list of ``(row, value)`` with nonzero values.
    """

    __slots__ = ("columns", "nr_rows")

    def __init__(self, columns: List[List[Entry]], nr_rows: int):
        self.columns = columns
        self.nr_rows = nr_rows

    @staticmethod
    def zeros(nr_rows: int, nr_columns: int) -> "SparseColumnMatrix":
        return SparseColumnMatrix([[] for _ in range(nr_columns)], nr_rows)

    @staticmethod
    def from_dense(rows: Sequence[Sequence[Fraction]]) -> "SparseColumnMatrix":
        nr_rows = len(rows)
        nr_cols = len(rows[0]) if nr_rows else 0
        columns: List[List[Entry]] = [[] for _ in range(nr_cols)]
        for i, row in enumerate(rows):
            for j, v in enumerate(row):
                if v != 0:
                    columns[j].append((i, Fraction(v)))
        return SparseColumnMatrix(columns, nr_rows)

    @property
    def nr_columns(self) -> int:
        return len(self.columns)

    def get(self, i: int, j: int) -> Fraction:
        col = self.columns[j]
        pos = bisect.bisect_left(col, i, key=lambda t: t[0])
        if pos < len(col) and col[pos][0] == i:
            return col[pos][1]
        return Fraction(0)

    def set(self, i: int, j: int, value: Fraction) -> None:
        col = self.columns[j]
        pos = bisect.bisect_left(col, i, key=lambda t: t[0])
        present = pos < len(col) and col[pos][0] == i
        if value == 0:
            if present:
                del col[pos]
        elif present:
            col[pos] = (i, value)
        else:
            col.insert(pos, (i, value))

    def column(self, j: int) -> List[Entry]:
        return self.columns[j]

    def iter_column(self, j: int) -> Iterator[Entry]:
        return iter(self.columns[j])

    def to_dense(self) -> List[List[Fraction]]:
        out = [[Fraction(0)] * self.nr_columns for _ in range(self.nr_rows)]
        for j, col in enumerate(self.columns):
            for i, v in col:
                out[i][j] = v
        return out

    def change_row_signs(self, rows: Sequence[int]) -> None:
        """Negate the given rows (reference: matrix.rs change_row_signs)."""
        to_flip = set(rows)
        if not to_flip:
            return
        for col in self.columns:
            for k, (i, v) in enumerate(col):
                if i in to_flip:
                    col[k] = (i, -v)

    def remove_columns(self, indices: Sequence[int]) -> None:
        removed = set(indices)
        self.columns = [c for j, c in enumerate(self.columns) if j not in removed]

    def remove_rows(self, indices: Sequence[int]) -> None:
        removed = sorted(set(indices))
        if not removed:
            return
        for j, col in enumerate(self.columns):
            out: List[Entry] = []
            k = 0
            removed_set = set(removed)
            for i, v in col:
                while k < len(removed) and removed[k] < i:
                    k += 1
                if i in removed_set:
                    continue
                out.append((i - k, v))
            self.columns[j] = out
        self.nr_rows -= len(removed)

    def concatenate_horizontally(self, other: "SparseColumnMatrix") -> "SparseColumnMatrix":
        if self.nr_rows != other.nr_rows:
            raise ValueError("row count mismatch")
        return SparseColumnMatrix(self.columns + other.columns, self.nr_rows)

    def transpose_entries(self) -> List[List[Entry]]:
        """Row-major view: list over rows of sorted (col, value)."""
        rows: List[List[Entry]] = [[] for _ in range(self.nr_rows)]
        for j, col in enumerate(self.columns):
            for i, v in col:
                rows[i].append((j, v))
        return rows

    def nnz(self) -> int:
        return sum(len(c) for c in self.columns)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, SparseColumnMatrix)
            and self.nr_rows == other.nr_rows
            and self.columns == other.columns
        )

    def __repr__(self) -> str:
        return f"SparseColumnMatrix(nr_rows={self.nr_rows}, nr_columns={self.nr_columns}, nnz={self.nnz()})"
