"""Exact post-optimality sensitivity analysis.

Given the certified optimal basis of a standard-form LP (min c'x, Ax = b,
x >= 0 — the form every ``MatrixProvider`` presents, cf. the reference's
``MatrixData`` layout, matrix_data.rs:46-102), this module computes, over
exact rational arithmetic:

- shadow prices (duals) ``y`` per row and reduced costs ``d_j = c_j - y.a_j``
  per nonbasic column;
- **RHS ranging**: for each row ``i`` the closed interval of ``b_i`` values
  for which the current basis stays primal feasible (and hence optimal),
  plus the rate ``dz/db_i = y_i``;
- **cost ranging**: for each column ``j`` the interval of ``c_j`` values for
  which the current basis stays dual feasible (and hence optimal).

All quantities are exact ``Fraction``s derived from Dixon solves against the
basis matrix — there is no float noise in the reported intervals, so interval
endpoints are mathematically sharp (a property float LP solvers cannot
offer).  The reference has no sensitivity machinery at all; this is
beyond-reference capability built on the same certified-basis substrate as
``relp_tpu_torch.exact.certify`` (whose invariants mirror
``debug_assert_in_basic_feasible_solution_state``, tableau/mod.rs:319-357).

Cost: one transposed Dixon solve per *basic* cost range and one forward
solve per RHS range, each O(m^2) after the shared O(m^3)-ish setup; pass
``rows=`` / ``columns=`` to restrict the scan on large problems.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from relp_tpu_torch.exact.certify import _basis_columns, _cost_of
from relp_tpu_torch.exact.dixon import ExactSolver
from relp_tpu_torch.providers.base import MatrixProvider

# An interval endpoint of None means unbounded in that direction.
Interval = Tuple[Optional[Fraction], Optional[Fraction]]


@dataclass
class SensitivityReport:
    """Exact sensitivity data for one certified optimal basis."""

    basis: List[int]
    objective: Fraction
    x_basic: List[Fraction]
    duals: List[Fraction]
    # Reduced cost per nonbasic column index (basic columns have 0).
    reduced_costs: Dict[int, Fraction] = field(default_factory=dict)
    # Row index -> (b_i low, b_i high) keeping the basis optimal.
    rhs_ranges: Dict[int, Interval] = field(default_factory=dict)
    # Column index -> (c_j low, c_j high) keeping the basis optimal.
    cost_ranges: Dict[int, Interval] = field(default_factory=dict)


def _unit(m: int, i: int) -> List[Fraction]:
    e = [Fraction(0)] * m
    e[i] = Fraction(1)
    return e


class ExactSensitivity:
    """Incremental exact sensitivity analysis against one optimal basis.

    Construct once (factorizes the basis mod p), then query ranges for
    individual rows/columns or build a full :class:`SensitivityReport`.
    """

    def __init__(
        self,
        provider: MatrixProvider,
        basis: Sequence[int],
        art_offset: Optional[int] = None,
        solver: Optional[ExactSolver] = None,
    ):
        self.provider = provider
        self.basis = list(basis)
        self.art_offset = art_offset
        self.m = len(self.basis)
        columns = _basis_columns(provider, self.basis, art_offset)
        self.solver = solver if solver is not None else ExactSolver(columns)
        self._tsolver: Optional[ExactSolver] = None
        self.b = provider.right_hand_side()
        self.x = self.solver.solve(self.b)
        cB = [_cost_of(provider, j, art_offset) for j in self.basis]
        self.y = self.transposed().solve(cB)
        self.objective = sum(ci * xi for ci, xi in zip(cB, self.x))
        self._row_of = {j: r for r, j in enumerate(self.basis)}

    def transposed(self) -> ExactSolver:
        if self._tsolver is None:
            self._tsolver = self.solver.transposed()
        return self._tsolver

    # -- first-order quantities ------------------------------------------

    def reduced_cost(self, j: int) -> Fraction:
        """Exact d_j = c_j - y.a_j (0 for basic columns)."""
        if j in self._row_of:
            return Fraction(0)
        d = _cost_of(self.provider, j, self.art_offset)
        for i, v in self._column_entries(j):
            d -= self.y[i] * v
        return d

    def _column_entries(self, j: int):
        if self.art_offset is not None and j >= self.art_offset:
            return [(j - self.art_offset, Fraction(1))]
        return self.provider.column(j).entries()

    # -- RHS ranging ------------------------------------------------------

    def rhs_range(self, i: int) -> Interval:
        """Interval of b_i keeping the basis feasible.

        x_B(theta) = x_B + theta * B^-1 e_i must stay >= 0; the allowed
        theta interval shifted by b_i gives the range.  dz/db_i inside the
        interval is exactly y_i.
        """
        h = self.solver.solve(_unit(self.m, i))
        lo: Optional[Fraction] = None  # max over h_k > 0 of -x_k/h_k
        hi: Optional[Fraction] = None  # min over h_k < 0 of -x_k/h_k
        for k, hk in enumerate(h):
            if hk == 0:
                continue
            bound = -self.x[k] / hk
            if hk > 0:
                if lo is None or bound > lo:
                    lo = bound
            else:
                if hi is None or bound < hi:
                    hi = bound
        bi = self.b[i]
        return (
            None if lo is None else bi + lo,
            None if hi is None else bi + hi,
        )

    # -- cost ranging -----------------------------------------------------

    def cost_range(self, j: int) -> Interval:
        """Interval of c_j keeping the basis dual feasible.

        Nonbasic j: d_j shrinks one-for-one as c_j drops, so the range is
        [y.a_j, +inf).  Basic j in row r: every nonbasic reduced cost moves
        by -theta * alpha_q with alpha_q = (B^-T e_r).a_q.
        """
        cj = _cost_of(self.provider, j, self.art_offset)
        r = self._row_of.get(j)
        if r is None:
            dj = self.reduced_cost(j)
            return (cj - dj, None)

        z = self.transposed().solve(_unit(self.m, r))
        lo_shift: Optional[Fraction] = None
        hi_shift: Optional[Fraction] = None
        # Only structural columns constrain dual feasibility; nonbasic
        # artificial columns are not part of the real LP.
        for q in range(self.provider.nr_columns()):
            if q in self._row_of:
                continue
            alpha = Fraction(0)
            for i, v in self._column_entries(q):
                alpha += z[i] * v
            if alpha == 0:
                continue
            dq = self.reduced_cost(q)
            bound = dq / alpha
            if alpha > 0:
                # d_q(theta) = d_q - theta*alpha >= 0  ->  theta <= d_q/alpha
                if hi_shift is None or bound < hi_shift:
                    hi_shift = bound
            else:
                if lo_shift is None or bound > lo_shift:
                    lo_shift = bound
        return (
            None if lo_shift is None else cj + lo_shift,
            None if hi_shift is None else cj + hi_shift,
        )

    # -- full report ------------------------------------------------------

    def report(
        self,
        rows: Optional[Sequence[int]] = None,
        columns: Optional[Sequence[int]] = None,
    ) -> SensitivityReport:
        """Build a full report; restrict with rows=/columns= on big LPs."""
        rows = range(self.m) if rows is None else rows
        if columns is None:
            columns = range(self.provider.nr_columns())
        rep = SensitivityReport(
            basis=list(self.basis),
            objective=self.objective,
            x_basic=list(self.x),
            duals=list(self.y),
        )
        for j in columns:
            if j not in self._row_of:
                rep.reduced_costs[j] = self.reduced_cost(j)
        for i in rows:
            rep.rhs_ranges[i] = self.rhs_range(i)
        for j in columns:
            rep.cost_ranges[j] = self.cost_range(j)
        return rep


def exact_sensitivity(
    provider: MatrixProvider,
    result,
    rows: Optional[Sequence[int]] = None,
    columns: Optional[Sequence[int]] = None,
) -> SensitivityReport:
    """Sensitivity report for a solved (ideally certified) result.

    ``result`` must carry the final basis (``result.basis``, set by the
    exact certification pass).  Raises ValueError otherwise.
    """
    basis = getattr(result, "basis", None)
    if not basis:
        raise ValueError(
            "result has no final basis; solve with certify=True so the "
            "exact certification pass records result.basis"
        )
    art_offset = getattr(result, "art_offset", None)
    analyzer = ExactSensitivity(provider, basis, art_offset=art_offset)
    return analyzer.report(rows=rows, columns=columns)
