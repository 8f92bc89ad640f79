"""Network modeling kit.

Mirror of reference ``src/data/linear_program/network/representation.rs`` and
the shortest-path / max-flow examples: an arc-incidence matrix over a
directed graph (vertex rows may be removed to keep the system full-rank and
b nonnegative), plus two custom :class:`MatrixProvider`s demonstrating lazy
column generation — the simplex never sees a materialized matrix, columns are
synthesized from the graph on demand.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from relp_tpu_torch.data.elements import BoundDirection
from relp_tpu_torch.linalg.sparse import SparseVector
from relp_tpu_torch.providers.base import MatrixProvider, PartialInitialBasis
from relp_tpu_torch.providers.column import Column, SparseColumn

ONE = Fraction(1)
MINUS_ONE = Fraction(-1)

# Arc orientation values (reference: ArcDirection::{Incoming=+1, Outgoing=-1}).
INCOMING = ONE
OUTGOING = MINUS_ONE

Adjacency = Sequence[Sequence[Fraction]]  # adjacency[to][from] = value (dense)


class IncidenceMatrix:
    """Vertex x arc incidence matrix from an adjacency matrix.

    ``adjacency[to][from] != 0`` declares an arc from->to carrying that value
    (cost or capacity); ``removed`` vertex rows are dropped and the remaining
    rows reindexed (reference: IncidenceMatrix::new, representation.rs:21-97).
    """

    def __init__(self, adjacency: Adjacency, removed: Sequence[int] = ()):
        nr_vertices = len(adjacency)
        assert all(len(row) == nr_vertices for row in adjacency)
        assert all(adjacency[j][j] == 0 for j in range(nr_vertices))
        self.removed = sorted(set(removed))
        removed_set = set(self.removed)

        def shifted(v: int) -> Optional[int]:
            if v in removed_set:
                return None
            return v - sum(1 for r in self.removed if r < v)

        self.arcs: List[Tuple[int, int]] = []  # (from, to) original indices
        self.values: List[Fraction] = []
        self.columns: List[List[Tuple[int, Fraction]]] = []
        # Arc order: by 'from' vertex, then 'to' (reference flat_maps the
        # column-major adjacency by outgoing vertex).
        for frm in range(nr_vertices):
            for to in range(nr_vertices):
                value = adjacency[to][frm]
                if value == 0:
                    continue
                entries = []
                f_idx, t_idx = shifted(frm), shifted(to)
                if f_idx is not None:
                    entries.append((f_idx, OUTGOING))
                if t_idx is not None:
                    entries.append((t_idx, INCOMING))
                entries.sort(key=lambda t: t[0])
                self.arcs.append((frm, to))
                self.values.append(Fraction(value))
                self.columns.append(entries)
        self.nr_rows = nr_vertices - len(self.removed)
        self._nr_vertices = nr_vertices

    def nr_vertices(self) -> int:
        return self._nr_vertices

    def nr_edges(self) -> int:
        return len(self.arcs)

    def column(self, j: int) -> List[Tuple[int, Fraction]]:
        return self.columns[j]

    def shifted_vertex(self, v: int) -> int:
        assert v not in self.removed
        return v - sum(1 for r in self.removed if r < v)


class ShortestPathPrimal(MatrixProvider):
    """Shortest s-t path as an LP (reference: examples/shortest_path.rs).

    Flow-conservation rows for every vertex except ``s`` (removed to keep
    the system full-rank with b >= 0); rhs is the unit vector at ``t``; arc
    costs are the lengths.
    """

    def __init__(self, adjacency: Adjacency, s: int, t: int):
        nr_vertices = len(adjacency)
        assert s < nr_vertices and t < nr_vertices and s != t
        self.incidence = IncidenceMatrix(adjacency, removed=[s])
        self.s, self.t = s, t

    def column(self, j: int) -> Column:
        return SparseColumn(self.incidence.column(j))

    def cost_value(self, j: int) -> Fraction:
        return self.incidence.values[j]

    def right_hand_side(self) -> List[Fraction]:
        b = [Fraction(0)] * self.incidence.nr_rows
        b[self.incidence.shifted_vertex(self.t)] = ONE
        return b

    def bound_row_index(self, j: int, direction: BoundDirection) -> Optional[int]:
        return None

    def nr_constraints(self) -> int:
        return self.incidence.nr_rows

    def nr_variable_bounds(self) -> int:
        return 0

    def nr_columns(self) -> int:
        return self.incidence.nr_edges()

    def reconstruct_solution(self, column_values: SparseVector) -> SparseVector:
        return column_values

    def arc_of_column(self, j: int) -> Tuple[int, int]:
        return self.incidence.arcs[j]


class MaxFlowPrimal(PartialInitialBasis):
    """Maximum s-t flow as an LP (reference: examples/max_flow.rs).

    Conservation rows for vertices other than s/t, one capacity bound row
    per arc; columns are the arcs (incidence + capacity slot) followed by
    capacity slack columns; cost -1 on arcs leaving s (maximize outflow as a
    minimization).
    """

    def __init__(self, adjacency: Adjacency, s: int, t: int):
        nr_vertices = len(adjacency)
        assert s < nr_vertices and t < nr_vertices and s != t
        self.incidence = IncidenceMatrix(adjacency, removed=[s, t])
        self.s, self.t = s, t
        self.capacity = self.incidence.values

    def nr_edges(self) -> int:
        return self.incidence.nr_edges()

    def column(self, j: int) -> Column:
        assert j < self.nr_columns()
        if j < self.nr_edges():
            entries = list(self.incidence.column(j))
            entries.append((self.nr_constraints() + j, INCOMING))
            return SparseColumn(entries)
        k = j - self.nr_edges()
        return SparseColumn([(self.nr_constraints() + k, INCOMING)])

    def cost_value(self, j: int) -> Fraction:
        if j < self.nr_edges() and self.incidence.arcs[j][0] == self.s:
            return MINUS_ONE
        return Fraction(0)

    def right_hand_side(self) -> List[Fraction]:
        b = [Fraction(0)] * self.nr_constraints()
        b.extend(self.capacity)
        return b

    def bound_row_index(self, j: int, direction: BoundDirection) -> Optional[int]:
        if direction is BoundDirection.UPPER and j < self.nr_edges():
            return self.nr_constraints() + j
        return None

    def nr_constraints(self) -> int:
        return self.incidence.nr_rows

    def nr_variable_bounds(self) -> int:
        return self.nr_edges()

    def nr_columns(self) -> int:
        return 2 * self.nr_edges()

    def reconstruct_solution(self, column_values: SparseVector) -> SparseVector:
        entries = [(j, v) for j, v in column_values if j < self.nr_edges()]
        return SparseVector(entries, self.nr_edges(), _trusted=True)

    def pivot_element_indices(self) -> List[Tuple[int, int]]:
        return [
            (self.nr_constraints() + k, self.nr_edges() + k)
            for k in range(self.nr_edges())
        ]

    def flow_value(self, column_values: SparseVector) -> Fraction:
        """Total flow out of s for an arc-flow solution."""
        total = Fraction(0)
        for j, v in column_values:
            if j < self.nr_edges() and self.incidence.arcs[j][0] == self.s:
                total += v
        return total
