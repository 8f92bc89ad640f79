"""Column types.

Mirror of reference ``matrix_provider/column``: cheap, iterable sparse columns.
The reference's GAT-iterator machinery collapses to plain tuples here; the
zero-allocation ``Binary``/``One`` value types are unnecessary — slack values
are literal ±1 rationals.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Iterator, List, Sequence, Tuple

Entry = Tuple[int, Fraction]

ONE = Fraction(1)
MINUS_ONE = Fraction(-1)


class Column:
    """A sparse standard-form column: iterable of (row, value)."""

    def iter_entries(self) -> Iterator[Entry]:
        raise NotImplementedError

    def entries(self) -> List[Entry]:
        return list(self.iter_entries())

    def removing_rows(self, index_map: Sequence[int]) -> "SparseColumn":
        """Column with rows remapped (dropped rows marked -1 in the map).

        Mirrors ``IntoFilteredColumn`` (reference: matrix_data.rs:663-692).
        """
        return SparseColumn(
            [(index_map[i], v) for i, v in self.iter_entries() if index_map[i] >= 0]
        )

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Column) and self.entries() == other.entries()


class SparseColumn(Column):
    """General sparse column, optionally with a trailing slack entry
    (reference: Column::Sparse)."""

    __slots__ = ("_entries",)

    def __init__(self, entries: Sequence[Entry]):
        self._entries = [(int(i), Fraction(v)) for i, v in entries if v != 0]
        self._entries.sort(key=lambda t: t[0])

    def iter_entries(self) -> Iterator[Entry]:
        return iter(self._entries)


class SlackColumn(Column):
    """Single ±1 entry (reference: Column::Slack)."""

    __slots__ = ("row", "value")

    def __init__(self, row: int, value: Fraction = ONE):
        self.row = row
        self.value = value

    def iter_entries(self) -> Iterator[Entry]:
        yield (self.row, self.value)


class TwoSlackColumn(Column):
    """Two +1 entries — range slacks (reference: Column::TwoSlack)."""

    __slots__ = ("row_a", "row_b")

    def __init__(self, row_a: int, row_b: int):
        self.row_a = row_a
        self.row_b = row_b

    def iter_entries(self) -> Iterator[Entry]:
        first, second = sorted((self.row_a, self.row_b))
        yield (first, ONE)
        yield (second, ONE)


class IdentityColumn(Column):
    """e_i — artificial columns (reference: column/identity.rs)."""

    __slots__ = ("row",)

    def __init__(self, row: int):
        self.row = row

    def iter_entries(self) -> Iterator[Entry]:
        yield (self.row, ONE)
