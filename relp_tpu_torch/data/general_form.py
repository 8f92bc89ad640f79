"""The mutable, storage-independent LP representation.

Exact-rational mirror of the reference's
``src/data/linear_program/general_form/mod.rs``: a column-major constraint
matrix, ranged constraint types, right-hand side, and per-variable
cost/bounds/shift/flip state, plus the original<->active variable maps used to
reconstruct full solutions after presolve/standardization.

Standardization follows general_form/mod.rs:500-716 exactly:
split free variables (x = x+ - x-), flip variables with only an upper bound,
shift lower bounds to zero, negate rows so b >= 0, force minimization, and
stable-sort constraints by type (==, range, <=, >=).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple, Union

from relp_tpu_torch.data.elements import (
    LinearProgramError,
    LPStatus,
    Objective,
    RangedConstraintRelation,
    RangedKind,
    VariableType,
)
from relp_tpu_torch.data.solution import Solution
from relp_tpu_torch.linalg.sparse import SparseColumnMatrix, SparseVector


@dataclass
class Variable:
    """An active variable (reference: general_form/mod.rs:988-1012)."""

    variable_type: VariableType
    cost: Fraction
    lower_bound: Optional[Fraction]
    upper_bound: Optional[Fraction]
    shift: Fraction = field(default_factory=lambda: Fraction(0))
    flipped: bool = False

    def has_feasible_value(self) -> bool:
        if self.lower_bound is not None and self.upper_bound is not None:
            return self.lower_bound <= self.upper_bound
        return True

    def is_fixed(self) -> Optional[Fraction]:
        if (
            self.lower_bound is not None
            and self.upper_bound is not None
            and self.lower_bound == self.upper_bound
        ):
            return self.lower_bound
        return None

    def update_lower_bound(self, new_lower: Fraction) -> bool:
        """Tighten the lower bound; returns whether it changed."""
        if self.lower_bound is None or new_lower > self.lower_bound:
            self.lower_bound = new_lower
            return True
        return False

    def update_upper_bound(self, new_upper: Fraction) -> bool:
        if self.upper_bound is None or new_upper < self.upper_bound:
            self.upper_bound = new_upper
            return True
        return False


# --- Original-variable bookkeeping (reference: general_form/mod.rs:83-132) ---


@dataclass
class Active:
    """Original variable is still active, at this active index."""

    index: int


@dataclass
class ActiveFree:
    """Free original variable split as x = x+ - x- (indices of x+, x-)."""

    positive: int
    negative: int


@dataclass
class Solved:
    """Removed with an explicit value."""

    value: Fraction


@dataclass
class FunctionOfOthers:
    """Removed; value = constant - <coefficients, x_original>.

    Coefficient indices refer to *original* variable indices
    (reference: RemovedVariable::FunctionOfOthers).
    """

    constant: Fraction
    coefficients: List[Tuple[int, Fraction]]


OriginalVariable = Union[Active, ActiveFree, Solved, FunctionOfOthers]


class GeneralForm:
    """Mutable LP in general form over exact rationals."""

    def __init__(
        self,
        objective: Objective,
        constraints: SparseColumnMatrix,
        constraint_types: List[RangedConstraintRelation],
        b: List[Fraction],
        variables: List[Variable],
        variable_names: List[str],
        fixed_cost: Fraction = Fraction(0),
    ):
        self.objective = objective
        self.constraints = constraints
        self.constraint_types = constraint_types
        self.b = b
        self.variables = variables
        self.fixed_cost = fixed_cost
        self.original_variables: List[Tuple[str, OriginalVariable]] = [
            (name, Active(j)) for j, name in enumerate(variable_names)
        ]
        self.from_active_to_original: List[int] = list(range(len(variables)))
        assert self.is_consistent()

    # --- shape/consistency ---

    def nr_constraints(self) -> int:
        return len(self.constraint_types)

    def nr_variables(self) -> int:
        return len(self.variables)

    def is_consistent(self) -> bool:
        """Structural invariants (reference: is_consistent, mod.rs:138-204)."""
        ok = (
            self.constraints.nr_rows == len(self.constraint_types) == len(self.b)
            and self.constraints.nr_columns == len(self.variables)
            and len(self.from_active_to_original) == len(self.variables)
        )
        if not ok:
            return False
        for j, orig in enumerate(self.from_active_to_original):
            entry = self.original_variables[orig][1]
            if isinstance(entry, Active):
                if entry.index != j:
                    return False
            elif isinstance(entry, ActiveFree):
                if j not in (entry.positive, entry.negative):
                    return False
            else:
                return False
        return True

    # --- presolve (delegates to relp_tpu_torch.data.presolve) ---

    def presolve(self, mip_safe: bool = False) -> None:
        """Apply the presolve fixpoint in place.

        Raises :class:`LinearProgramError` carrying a full :class:`Solution`
        if the problem is completely solved by presolve, or an
        infeasible/unbounded verdict (reference: general_form/mod.rs:351-375).
        ``mip_safe`` restricts to integer-hull-preserving rules
        (:func:`relp_tpu_torch.data.presolve.index.compute_presolve_changes`).
        """
        from relp_tpu_torch.data.presolve import presolve as _presolve

        _presolve(self, mip_safe=mip_safe)

    # --- prescaling (reference: Scalable, presolve/scale/mod.rs:21-51) ---

    def scale(self):
        """Apply the exact rational prime-factor prescaler in place and
        return the :class:`~relp_tpu_torch.data.scale.Scaling` to undo it / map
        solutions back (reference: Scalable::scale)."""
        from relp_tpu_torch.data.scale import scale_general_form

        return scale_general_form(self)

    def scale_back(self, scaling) -> None:
        """Undo a :meth:`scale` in place (reference: Scalable::scale_back)."""
        from relp_tpu_torch.data.scale import scale_back_general_form

        scale_back_general_form(self, scaling)

    # --- standardization (reference: mod.rs:325-332) ---

    def standardize(self) -> List[int]:
        """Transform toward standard form; returns [nr_eq, nr_range, nr_le, nr_ge]."""
        self.transform_variables()
        self.make_b_non_negative()
        self.make_minimization_problem()
        counts = self.reorder_constraints_by_type()
        return counts

    def transform_variables(self) -> None:
        """Split free vars, flip upper-only vars, shift lower bounds to zero
        (reference: mod.rs:506-546)."""
        self.split_free_variables()
        assert self.is_consistent()

        for j, variable in enumerate(self.variables):
            if variable.lower_bound is None and variable.upper_bound is not None:
                variable.flipped = not variable.flipped
                variable.shift = -variable.shift
                variable.cost = -variable.cost
                variable.lower_bound = -variable.upper_bound
                variable.upper_bound = None
                col = self.constraints.columns[j]
                for k, (i, v) in enumerate(col):
                    col[k] = (i, -v)

            if variable.lower_bound is not None:
                lower = variable.lower_bound
                if lower != 0:
                    variable.shift -= lower
                    if variable.upper_bound is not None:
                        variable.upper_bound -= lower
                    self.fixed_cost += lower * variable.cost
                    for i, coefficient in self.constraints.columns[j]:
                        self.b[i] -= coefficient * lower
                    variable.lower_bound = Fraction(0)

        assert self.is_consistent()

    def split_free_variables(self) -> None:
        """x free -> x+ - x-, appending the negative part (mod.rs:554-587)."""
        free = [
            j
            for j, v in enumerate(self.variables)
            if v.lower_bound is None and v.upper_bound is None
        ]
        if not free:
            return
        new_columns = [
            [(i, -v) for i, v in self.constraints.columns[j]] for j in free
        ]
        self.constraints = self.constraints.concatenate_horizontally(
            SparseColumnMatrix(new_columns, self.constraints.nr_rows)
        )
        for index in free:
            original_index = self.from_active_to_original[index]
            name = self.original_variables[original_index][0]
            self.original_variables[original_index] = (
                name,
                ActiveFree(index, len(self.from_active_to_original)),
            )
            self.from_active_to_original.append(original_index)
            src = self.variables[index]
            self.variables.append(
                Variable(
                    variable_type=src.variable_type,
                    cost=-src.cost,
                    lower_bound=Fraction(0),
                    upper_bound=None,
                )
            )
            src.lower_bound = Fraction(0)

    def make_b_non_negative(self) -> None:
        """Negate rows with negative b (mod.rs:592-620)."""
        rows_to_negate = [i for i, v in enumerate(self.b) if v < 0]
        if not rows_to_negate:
            return
        self.constraints.change_row_signs(rows_to_negate)
        for row in rows_to_negate:
            ct = self.constraint_types[row]
            if ct.kind is RangedKind.LESS:
                self.constraint_types[row] = RangedConstraintRelation.greater()
                self.b[row] = -self.b[row]
            elif ct.kind is RangedKind.EQUAL:
                self.b[row] = -self.b[row]
            elif ct.kind is RangedKind.GREATER:
                self.constraint_types[row] = RangedConstraintRelation.less()
                self.b[row] = -self.b[row]
            else:  # Range: b - r <= <a,x> <= b flips to r - b >= -<a,x> >= -b,
                # i.e. new upper end is r - b with the same width r.
                assert ct.range is not None
                self.b[row] = ct.range - self.b[row]
        assert self.is_consistent()

    def make_minimization_problem(self) -> None:
        if self.objective is Objective.MAXIMIZE:
            self.objective = Objective.MINIMIZE
            for variable in self.variables:
                variable.cost = -variable.cost
            # fixed_cost accumulated so far (presolve fixings, lower-bound
            # shifts) is in the original MAXIMIZE sense; negate it so the
            # whole accounting is coherently in the minimize sense.  The
            # reference negates only the variable costs (mod.rs:623-631) and
            # runs this BEFORE transform_variables, leaving presolve-fixed
            # cost contributions un-negated on maximize problems — an
            # untested incoherence there; here the reported convention
            # (Solution carries the minimize-form objective, see the
            # reference's cook fixture expecting -143/2) holds exactly.
            self.fixed_cost = -self.fixed_cost

    def reorder_constraints_by_type(self) -> List[int]:
        """Stable-sort rows as ==, range, <=, >= (mod.rs:651-716)."""
        order = {
            RangedKind.EQUAL: 0,
            RangedKind.RANGE: 1,
            RangedKind.LESS: 2,
            RangedKind.GREATER: 3,
        }
        counters = [0, 0, 0, 0]
        within_group: List[int] = []
        for ct in self.constraint_types:
            g = order[ct.kind]
            within_group.append(counters[g])
            counters[g] += 1
        offsets = [0, counters[0], counters[0] + counters[1], counters[0] + counters[1] + counters[2]]
        destination = [
            offsets[order[ct.kind]] + within_group[i]
            for i, ct in enumerate(self.constraint_types)
        ]

        new_b: List[Fraction] = [Fraction(0)] * len(self.b)
        new_types: List[Optional[RangedConstraintRelation]] = [None] * len(self.b)
        for i, dest in enumerate(destination):
            new_b[dest] = self.b[i]
            new_types[dest] = self.constraint_types[i]
        self.b = new_b
        self.constraint_types = [t for t in new_types if t is not None]

        for col in self.constraints.columns:
            for k, (i, v) in enumerate(col):
                col[k] = (destination[i], v)
            col.sort(key=lambda t: t[0])
        assert self.is_consistent()
        return counters

    # --- lowering to the standard-form provider ---

    def derive_matrix_data(self, constraint_type_counts: Sequence[int]):
        """Build the standard-form MatrixData view (mod.rs:262-302)."""
        from relp_tpu_torch.providers.matrix_data import MatrixData

        nr_eq, nr_range, nr_le, nr_ge = constraint_type_counts
        assert nr_eq + nr_range + nr_le + nr_ge == self.nr_constraints()
        ranges = []
        for ct in self.constraint_types[nr_eq : nr_eq + nr_range]:
            assert ct.kind is RangedKind.RANGE and ct.range is not None
            ranges.append(ct.range)
        return MatrixData(
            constraints=self.constraints,
            b=self.b,
            ranges=ranges,
            nr_equality=nr_eq,
            nr_range=nr_range,
            nr_upper=nr_le,
            nr_lower=nr_ge,
            variables=self.variables,
        )

    # --- solution reconstruction (reference: mod.rs:799-933) ---

    def reshift_solution(self, reduced_solution: SparseVector) -> None:
        """Undo per-variable shift then flip, in place."""
        assert reduced_solution.length == len(self.variables)
        for j, variable in enumerate(self.variables):
            if variable.shift != 0:
                reduced_solution.set(j, reduced_solution.get(j) - variable.shift)
            if variable.flipped:
                value = reduced_solution.get(j)
                if value != 0:
                    reduced_solution.set(j, -value)

    def compute_full_solution_with_reduced_solution(
        self, reduced_solution: SparseVector
    ) -> Solution:
        """Extend active-variable values to a full original-variable solution."""
        assert reduced_solution.length == len(self.variables)

        cost = (
            sum(
                (v * self.variables[j].cost for j, v in reduced_solution),
                Fraction(0),
            )
            + self.fixed_cost
        )
        self.reshift_solution(reduced_solution)

        new_solutions: List[Optional[Fraction]] = [None] * len(self.original_variables)
        for j in range(len(self.original_variables)):
            self._solution_value(j, new_solutions, reduced_solution)
        assert all(v is not None for v in new_solutions)

        return Solution(
            cost,
            [
                (name, value)
                for (name, _), value in zip(self.original_variables, new_solutions)  # type: ignore[misc]
            ],
        )

    def _solution_value(
        self,
        variable: int,
        new_solutions: List[Optional[Fraction]],
        reduced_solution: SparseVector,
    ) -> Fraction:
        if new_solutions[variable] is not None:
            return new_solutions[variable]  # type: ignore[return-value]

        entry = self.original_variables[variable][1]
        if isinstance(entry, Active):
            value = reduced_solution.get(entry.index)
        elif isinstance(entry, ActiveFree):
            value = reduced_solution.get(entry.positive) - reduced_solution.get(entry.negative)
        elif isinstance(entry, Solved):
            value = entry.value
        else:  # FunctionOfOthers: constant - <coefficients, x_original>
            value = entry.constant - sum(
                (
                    coefficient
                    * self._solution_value(j, new_solutions, reduced_solution)
                    for j, coefficient in entry.coefficients
                ),
                Fraction(0),
            )
        new_solutions[variable] = value
        return value

    def compute_solution_where_possible(self) -> None:
        """Resolve FunctionOfOthers chains whose inputs are all Solved
        (reference: compute_solution_where_possible)."""
        new_solutions: List[Optional[Fraction]] = [None] * len(self.original_variables)

        def resolve(variable: int, visiting: set) -> Optional[Fraction]:
            if new_solutions[variable] is not None:
                return new_solutions[variable]
            if variable in visiting:
                return None
            entry = self.original_variables[variable][1]
            if isinstance(entry, Solved):
                new_solutions[variable] = entry.value
                return entry.value
            if isinstance(entry, FunctionOfOthers):
                visiting.add(variable)
                total = entry.constant
                for j, coefficient in entry.coefficients:
                    sub = resolve(j, visiting)
                    if sub is None:
                        visiting.discard(variable)
                        return None
                    total -= coefficient * sub
                visiting.discard(variable)
                name = self.original_variables[variable][0]
                self.original_variables[variable] = (name, Solved(total))
                new_solutions[variable] = total
                return total
            return None

        for j in range(len(self.original_variables)):
            resolve(j, set())

    def get_solution(self) -> Optional[Solution]:
        """Full solution if every original variable is Solved."""
        values: List[Tuple[str, Fraction]] = []
        for name, entry in self.original_variables:
            if isinstance(entry, Solved):
                values.append((name, entry.value))
            else:
                return None
        return Solution(self.fixed_cost, values)

    def __repr__(self) -> str:
        return (
            f"GeneralForm(m={self.nr_constraints()}, n={self.nr_variables()}, "
            f"nnz={self.constraints.nnz()}, objective={self.objective.value})"
        )
