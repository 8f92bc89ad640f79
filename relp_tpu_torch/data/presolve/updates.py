"""Presolve updates — copy-on-write overlay over the immutable GeneralForm.

Mirror of reference ``presolve/updates.rs``: proposed new b values, constraint
types, variable bounds (with separately-tracked *activity-derived* bounds that
are only committed when useful), removed variables with their solutions, and
removed constraints; finalized into a ``Changes`` batch.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Tuple, Union

from relp_tpu_torch.data.elements import (
    BoundDirection,
    LinearProgramError,
    LPStatus,
    Objective,
    RangedConstraintRelation,
    RangedKind,
    VariableType,
)
from relp_tpu_torch.data.general_form import (
    FunctionOfOthers,
    GeneralForm,
    Solved,
)


def safe_float(x: Fraction) -> float:
    """float(Fraction) that saturates to +-inf instead of raising on
    enormous values (the screen then treats the value as undecidable)."""
    try:
        return float(x)
    except OverflowError:
        import math

        return math.inf if x > 0 else -math.inf


class BoundChangeKind(enum.Enum):
    NONE = "none"
    NEW = "new"
    SHIFT = "shift"


@dataclass
class BoundChange:
    kind: BoundChangeKind
    shift: Optional[Fraction] = None

    @staticmethod
    def none() -> "BoundChange":
        return BoundChange(BoundChangeKind.NONE)

    @staticmethod
    def new() -> "BoundChange":
        return BoundChange(BoundChangeKind.NEW)

    @staticmethod
    def shifted(difference: Fraction) -> "BoundChange":
        return BoundChange(BoundChangeKind.SHIFT, difference)


RemovedVariable = Union[Solved, FunctionOfOthers]


def optimize_independent_column(
    objective: Objective,
    cost: Fraction,
    bounds: Tuple[Optional[Fraction], Optional[Fraction]],
) -> Fraction:
    """Optimal value for a variable appearing only in the objective.

    Raises Unbounded when the profitable direction has no bound
    (reference: updates.rs optimize_independent_column).
    """
    lower, upper = bounds
    wants_small = (cost > 0) == (objective is Objective.MINIMIZE)
    chosen = lower if wants_small else upper
    if chosen is None:
        raise LinearProgramError(LPStatus.UNBOUNDED)
    return chosen


@dataclass
class Changes:
    """Finalized presolve result (reference: updates.rs Changes)."""

    b: Dict[int, Fraction]
    constraints: List[Tuple[int, RangedConstraintRelation]]
    fixed_cost: Fraction
    bounds: Dict[Tuple[int, BoundDirection], Fraction]
    removed_variables: List[Tuple[int, RemovedVariable]]
    constraints_marked_removed: List[int]


class Updates:
    def __init__(
        self, general_form: GeneralForm, counters, mip_safe: bool = False
    ) -> None:
        self.gf = general_form
        #: MIP-safe mode: every new/tightened bound on an INTEGER variable
        #: is rounded inward (ceil for LOWER, floor for UPPER) — valid for
        #: the integer hull and strictly stronger than LP propagation
        #: (Achterberg 2007, alg. 7.1's integer case).
        self.mip_safe = mip_safe
        self.b: Dict[int, Fraction] = {}
        self.constraints: Dict[int, RangedConstraintRelation] = {}
        self.fixed_cost = Fraction(0)
        self.bounds: Dict[Tuple[int, BoundDirection], Fraction] = {}
        self.activity_bounds: Dict[Tuple[int, BoundDirection], Fraction] = {}
        self.removed_variables: List[Tuple[int, RemovedVariable]] = []
        self.constraints_marked_removed: List[int] = []
        # Float mirrors of the latest bounds/b, used ONLY by the domain-
        # propagation float screen (rules._for_entire_constraint).  Exact
        # values remain authoritative; every write above also writes the
        # mirror, reads are lazily cached from the exact value.
        self._bounds_f: Dict[Tuple[int, BoundDirection], Optional[float]] = {}
        self._b_f: Dict[int, float] = {}

        # Variables with no constraint entries are solved right away
        # (reference: Updates::new).
        for j, count in enumerate(counters.variable):
            if count == 0:
                variable = self.gf.variables[j]
                if not variable.has_feasible_value():
                    raise LinearProgramError(LPStatus.INFEASIBLE)
                if variable.cost == 0:
                    value = self._feasible_value_for(
                        variable.lower_bound, variable.upper_bound
                    )
                else:
                    value = optimize_independent_column(
                        self.gf.objective,
                        variable.cost,
                        (variable.lower_bound, variable.upper_bound),
                    )
                    self.fixed_cost += variable.cost * value
                self.removed_variables.append((j, Solved(value)))

        from relp_tpu_torch.data.presolve.index import is_empty_constraint_feasible

        for i, count in enumerate(counters.constraint):
            if count == 0:
                if is_empty_constraint_feasible(
                    self.gf.b[i], self.gf.constraint_types[i]
                ):
                    self.constraints_marked_removed.append(i)
                else:
                    raise LinearProgramError(LPStatus.INFEASIBLE)

    @staticmethod
    def _feasible_value_for(
        lower: Optional[Fraction], upper: Optional[Fraction]
    ) -> Fraction:
        # Prefer the upper bound: slacks at upper yield sparser solutions
        # (reference: variable_feasible_value).
        if lower is None and upper is None:
            return Fraction(0)
        if upper is not None:
            return upper
        return lower  # type: ignore[return-value]

    # --- latest-version accessors ---

    def b_value(self, constraint: int) -> Fraction:
        return self.b.get(constraint, self.gf.b[constraint])

    def b_value_f(self, constraint: int) -> float:
        value = self._b_f.get(constraint)
        if value is None:
            value = safe_float(self.b_value(constraint))
            self._b_f[constraint] = value
        return value

    def change_b(self, constraint: int, change: Fraction) -> None:
        new = self.b_value(constraint) + change
        self.b[constraint] = new
        self._b_f[constraint] = safe_float(new)

    def constraint_type(self, constraint: int) -> RangedConstraintRelation:
        return self.constraints.get(constraint, self.gf.constraint_types[constraint])

    def variable_bound(self, j: int, direction: BoundDirection) -> Optional[Fraction]:
        key = (j, direction)
        if key in self.activity_bounds:
            return self.activity_bounds[key]
        if key in self.bounds:
            return self.bounds[key]
        variable = self.gf.variables[j]
        return (
            variable.lower_bound
            if direction is BoundDirection.LOWER
            else variable.upper_bound
        )

    _MISSING = object()

    def variable_bound_f(self, j: int, direction: BoundDirection) -> Optional[float]:
        """Float mirror of ``variable_bound`` (None when unbounded)."""
        key = (j, direction)
        value = self._bounds_f.get(key, Updates._MISSING)
        if value is Updates._MISSING:
            exact = self.variable_bound(j, direction)
            value = None if exact is None else safe_float(exact)
            self._bounds_f[key] = value
        return value

    def is_variable_fixed(self, j: int) -> Optional[Fraction]:
        lower = self.variable_bound(j, BoundDirection.LOWER)
        upper = self.variable_bound(j, BoundDirection.UPPER)
        if lower is not None and lower == upper:
            return lower
        return None

    def variable_feasible_value(self, j: int) -> Optional[Fraction]:
        lower = self.variable_bound(j, BoundDirection.LOWER)
        upper = self.variable_bound(j, BoundDirection.UPPER)
        if lower is None and upper is None:
            return Fraction(0)
        if lower is None:
            return upper
        if upper is None:
            return lower
        return upper if lower <= upper else None

    # --- bound updates ---

    @staticmethod
    def _is_tighter(direction: BoundDirection, new: Fraction, old: Fraction) -> bool:
        return new > old if direction is BoundDirection.LOWER else new < old

    def _mip_round(
        self, j: int, direction: BoundDirection, new: Fraction
    ) -> Fraction:
        """Round a proposed bound on an integer variable inward (mip_safe)."""
        if (
            self.mip_safe
            and new.denominator != 1
            and self.gf.variables[j].variable_type is VariableType.INTEGER
        ):
            import math

            return Fraction(
                math.ceil(new)
                if direction is BoundDirection.LOWER
                else math.floor(new)
            )
        return new

    def update_bound(
        self, j: int, direction: BoundDirection, new: Fraction
    ) -> BoundChange:
        """Update a *permanent* bound (always exported).

        An activity-derived bound for the same (variable, direction) is
        promoted to permanent first (reference: update_bound).
        """
        new = self._mip_round(j, direction, new)
        key = (j, direction)
        if key not in self.bounds:
            if key in self.activity_bounds:
                self.bounds[key] = self.activity_bounds.pop(key)
            else:
                variable = self.gf.variables[j]
                original = (
                    variable.lower_bound
                    if direction is BoundDirection.LOWER
                    else variable.upper_bound
                )
                if original is None:
                    self.bounds[key] = new
                    self._bounds_f[key] = safe_float(new)
                    return BoundChange.new()
                if self._is_tighter(direction, new, original):
                    self.bounds[key] = new
                    self._bounds_f[key] = safe_float(new)
                    return BoundChange.shifted(new - original)
                return BoundChange.none()
        existing = self.bounds[key]
        if self._is_tighter(direction, new, existing):
            self.bounds[key] = new
            self._bounds_f[key] = safe_float(new)
            return BoundChange.shifted(new - existing)
        return BoundChange.none()

    def update_activity_variable_bound(
        self, j: int, direction: BoundDirection, new: Fraction
    ) -> BoundChange:
        """Update an *activity-derived* bound (exported only when useful)."""
        new = self._mip_round(j, direction, new)
        key = (j, direction)
        if key in self.activity_bounds:
            existing = self.activity_bounds[key]
            if self._is_tighter(direction, new, existing):
                self.activity_bounds[key] = new
                self._bounds_f[key] = safe_float(new)
                return BoundChange.shifted(new - existing)
            return BoundChange.none()
        if key in self.bounds:
            existing = self.bounds[key]
            if self._is_tighter(direction, new, existing):
                self.bounds[key] = new
                self._bounds_f[key] = safe_float(new)
                return BoundChange.shifted(new - existing)
            return BoundChange.none()
        variable = self.gf.variables[j]
        original = (
            variable.lower_bound
            if direction is BoundDirection.LOWER
            else variable.upper_bound
        )
        if original is None:
            self.activity_bounds[key] = new
            self._bounds_f[key] = safe_float(new)
            return BoundChange.new()
        if self._is_tighter(direction, new, original):
            self.activity_bounds[key] = new
            self._bounds_f[key] = safe_float(new)
            return BoundChange.shifted(new - original)
        return BoundChange.none()

    def optimize_column_independently(self, j: int) -> RemovedVariable:
        value = optimize_independent_column(
            self.gf.objective,
            self.gf.variables[j].cost,
            (
                self.variable_bound(j, BoundDirection.LOWER),
                self.variable_bound(j, BoundDirection.UPPER),
            ),
        )
        self.fixed_cost += self.gf.variables[j].cost * value
        return Solved(value)

    def nr_variables_remaining(self) -> int:
        return self.gf.nr_variables() - len(self.removed_variables)

    def nr_constraints_remaining(self) -> int:
        return self.gf.nr_constraints() - len(self.constraints_marked_removed)

    # --- finalization (reference: into_changes) ---

    def into_changes(self) -> Changes:
        for constraint in self.constraints_marked_removed:
            self.b.pop(constraint, None)
            self.constraints.pop(constraint, None)
        for j, _ in self.removed_variables:
            for d in (BoundDirection.LOWER, BoundDirection.UPPER):
                self.bounds.pop((j, d), None)
                self.activity_bounds.pop((j, d), None)

        # Keep activity-derived bounds only where they bound an otherwise
        # free variable.
        free_to_restrict = set()
        for (j, _), _v in self.activity_bounds.items():
            variable = self.gf.variables[j]
            if (
                variable.lower_bound is None
                and variable.upper_bound is None
                and (j, BoundDirection.LOWER) not in self.bounds
                and (j, BoundDirection.UPPER) not in self.bounds
            ):
                free_to_restrict.add(j)
        for (j, direction), value in self.activity_bounds.items():
            if j in free_to_restrict:
                self.bounds[(j, direction)] = value

        b = {
            i: value for i, value in self.b.items() if value != self.gf.b[i]
        }
        constraints = [
            (i, ct)
            for i, ct in self.constraints.items()
            if ct != self.gf.constraint_types[i]
        ]
        self.removed_variables.sort(key=lambda t: t[0])
        self.constraints_marked_removed.sort()

        return Changes(
            b=b,
            constraints=constraints,
            fixed_cost=self.fixed_cost,
            bounds=self.bounds,
            removed_variables=self.removed_variables,
            constraints_marked_removed=self.constraints_marked_removed,
        )
