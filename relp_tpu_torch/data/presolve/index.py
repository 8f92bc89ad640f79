"""Presolve engine — the queue-driven fixpoint.

Mirror of reference ``presolve/mod.rs``: an :class:`Index` holds queues,
counters and the copy-on-write :class:`~relp_tpu_torch.data.presolve.updates.Updates`
overlay; ``presolve_step`` applies the highest-priority applicable rule
(substitution > bound > slack > activity); the loop stops when queues drain or
the no-meaningful-change budget (nr_vars + nr_constraints remaining) trips.
"""

from __future__ import annotations

import enum
from fractions import Fraction
from typing import Optional, Tuple

from relp_tpu_torch.data.elements import (
    BoundDirection,
    LinearProgramError,
    LPStatus,
    RangedConstraintRelation,
    RangedKind,
)
from relp_tpu_torch.data.general_form import GeneralForm, Solved
from relp_tpu_torch.data.presolve.counters import Counters
from relp_tpu_torch.data.presolve.queues import Queues
from relp_tpu_torch.data.presolve.updates import (
    BoundChange,
    BoundChangeKind,
    Updates,
)
from relp_tpu_torch.numbers.rational import sign


class Change(enum.Enum):
    """Whether a rule application made a 'meaningful' change
    (reference: presolve/mod.rs Change)."""

    MEANINGFUL = "meaningful"
    NOT_MEANINGFUL = "not_meaningful"
    NONE = "none"


def is_empty_constraint_feasible(
    right_hand_side: Fraction, constraint_type: RangedConstraintRelation
) -> bool:
    """0 <relation> b feasibility for emptied rows
    (reference: presolve/mod.rs:403-425)."""
    kind = constraint_type.kind
    if kind is RangedKind.EQUAL:
        return right_hand_side == 0
    if kind is RangedKind.RANGE:
        return right_hand_side >= 0 and right_hand_side - constraint_type.range <= 0
    if kind is RangedKind.LESS:
        return right_hand_side >= 0
    return right_hand_side <= 0


class Index:
    def __init__(self, general_form: GeneralForm, mip_safe: bool = False):
        self.gf = general_form
        self.mip_safe = mip_safe
        self.counters = Counters(general_form)
        self.updates = Updates(general_form, self.counters, mip_safe=mip_safe)
        self.queues = Queues()

        # Seed the queues (reference: queues.rs:100-140).
        for i, count in enumerate(self.counters.constraint):
            if count == 1:
                self.queues.bound.push(i)
        for i, (lower_missing, upper_missing) in enumerate(
            (a[0], a[1]) for a in self.counters.activity
        ):
            if self.counters.constraint[i] > 1:
                if lower_missing <= 1:
                    self.queues.activity.push((i, BoundDirection.LOWER))
                if upper_missing <= 1:
                    self.queues.activity.push((i, BoundDirection.UPPER))
        for j, count in enumerate(self.counters.variable):
            if (
                count == 1
                and self.gf.variables[j].cost == 0
                and not self._slack_is_mip_unsafe(j)
            ):
                self.queues.slack.push(j)
        for j, variable in enumerate(self.gf.variables):
            if self.counters.variable[j] > 0 and variable.is_fixed() is not None:
                self.queues.substitution.push(j)

    def _slack_is_mip_unsafe(self, variable: int) -> bool:
        """In mip_safe mode, slack elimination of an INTEGER variable is
        gated: the removed column's value is reconstructed as a linear
        function of the other row entries (or pinned at a bound while the
        row is relaxed over its continuous range), which need not be
        integral — eliminating it would relax integrality."""
        if not self.mip_safe:
            return False
        from relp_tpu_torch.data.elements import VariableType

        return (
            self.gf.variables[variable].variable_type is VariableType.INTEGER
        )

    # --- the step (reference: presolve_step, rule priority order) ---

    def presolve_step(self) -> Change:
        variable = self.queues.substitution.pop()
        if variable is not None:
            if self.counters.is_variable_still_active(variable):
                from relp_tpu_torch.data.presolve.rules import presolve_fixed_variable

                presolve_fixed_variable(self, variable)
                return Change.MEANINGFUL

        while True:
            constraint = self.queues.bound.pop()
            if constraint is None:
                break
            if self.counters.is_constraint_still_active(constraint):
                from relp_tpu_torch.data.presolve.rules import presolve_bound_constraint

                presolve_bound_constraint(self, constraint)
                return Change.MEANINGFUL

        while True:
            variable = self.queues.slack.pop()
            if variable is None:
                break
            if self.counters.is_variable_still_active(variable):
                from relp_tpu_torch.data.presolve.rules import presolve_slack

                presolve_slack(self, variable)
                return Change.MEANINGFUL

        while True:
            item = self.queues.activity.pop()
            if item is None:
                break
            constraint, direction = item
            if self.counters.is_constraint_still_active(constraint):
                from relp_tpu_torch.data.presolve.rules import presolve_domain_propagation

                return presolve_domain_propagation(self, constraint, direction)

        return Change.NOT_MEANINGFUL

    # --- cascade helpers (reference: presolve/mod.rs:179-363) ---

    def after_bound_change(
        self,
        variable: int,
        direction: BoundDirection,
        change: Optional[Fraction],
    ) -> None:
        if (
            self.updates.is_variable_fixed(variable) is not None
            and self.counters.is_variable_still_active(variable)
        ):
            self.queues.substitution.push(variable)

        if change is not None:
            self.update_activity_bounds(variable, direction, change)
        else:
            self.update_activity_counters(variable, direction)

    def update_activity_bounds(
        self, variable: int, direction: BoundDirection, by_how_much: Fraction
    ) -> None:
        """An existing bound was tightened; requeue affected activity checks.

        The reference incrementally patches cached activity bounds
        (mod.rs:214-244); we recompute bounds on demand instead, so this just
        requeues the (row, side) pairs whose activity bound got tighter.
        """
        for row, coefficient in list(self.counters.iter_active_column(variable)):
            if not self.counters.is_constraint_still_active(row):
                continue
            bound_to_edit = direction.times_sign(sign(coefficient))
            if self.counters.activity_counter(row, bound_to_edit) <= 1:
                self.queues.activity.push((row, bound_to_edit))

    def update_activity_counters(
        self, variable: int, direction: BoundDirection
    ) -> None:
        for constraint, coefficient in list(
            self.counters.iter_active_column(variable)
        ):
            activity_direction = direction.times_sign(sign(coefficient))
            counter = self.counters.add_to_activity_counter(
                constraint, activity_direction, -1
            )
            if counter <= 1:
                self.queues.activity.push((constraint, activity_direction))

    def remove_constraint_values(self, constraint: int) -> None:
        for variable in [j for j, _ in self.counters.iter_active_row(constraint)]:
            self.counters.constraint[constraint] -= 1
            self.counters.variable[variable] -= 1
            self.queue_variable_by_counter(variable)
        assert self.counters.constraint[constraint] == 0

    def queue_variable_by_counter(self, variable: int) -> None:
        count = self.counters.variable[variable]
        if count == 0:
            feasible = self.updates.variable_feasible_value(variable)
            assert feasible is not None
            if self.gf.variables[variable].cost == 0:
                value: object = Solved(feasible)
            else:
                value = self.updates.optimize_column_independently(variable)
            self.remove_variable(variable, value)
        elif (
            count == 1
            and self.gf.variables[variable].cost == 0
            and not self._slack_is_mip_unsafe(variable)
        ):
            self.queues.slack.push(variable)

    def queue_constraint_by_counter(self, constraint: int) -> Change:
        count = self.counters.constraint[constraint]
        if count == 0:
            if is_empty_constraint_feasible(
                self.updates.b_value(constraint),
                self.updates.constraint_type(constraint),
            ):
                self.remove_constraint(constraint)
                return Change.MEANINGFUL
            raise LinearProgramError(LPStatus.INFEASIBLE)
        if count == 1:
            self.queues.bound.push(constraint)
        return Change.NONE

    def remove_constraint(self, constraint: int) -> None:
        assert self.counters.constraint[constraint] == 0
        self.updates.constraints_marked_removed.append(constraint)

    def remove_variable(self, variable: int, solution) -> None:
        assert self.counters.variable[variable] == 0
        self.updates.removed_variables.append((variable, solution))

    def are_queues_empty(self) -> bool:
        return self.queues.are_empty()


def compute_presolve_changes(general_form: GeneralForm, mip_safe: bool = False):
    """Run the fixpoint and return the Changes batch
    (reference: compute_presolve_changes, general_form/mod.rs:386-409).

    ``mip_safe`` restricts the rules to transformations valid for the
    *integer hull* (beyond reference scope — the reference has no MIP
    presolve): integer bounds round inward, integer slacks are never
    eliminated, and an integer variable fixed at a fractional value is
    INFEASIBLE.
    """
    index = Index(general_form, mip_safe=mip_safe)

    iterations_without_meaningful_change = 0
    while not index.are_queues_empty() and iterations_without_meaningful_change < (
        index.updates.nr_variables_remaining()
        + index.updates.nr_constraints_remaining()
    ):
        change = index.presolve_step()
        if change is Change.MEANINGFUL:
            iterations_without_meaningful_change = 0
        elif change is Change.NOT_MEANINGFUL:
            iterations_without_meaningful_change += 1

    return index.updates.into_changes()


def presolve(general_form: GeneralForm, mip_safe: bool = False) -> None:
    """Presolve in place (reference: GeneralForm::presolve).

    Raises :class:`LinearProgramError` with FINITE_OPTIMUM and a full
    :class:`Solution` payload if presolve solves the problem entirely, or with
    an INFEASIBLE / UNBOUNDED verdict.  ``mip_safe``: see
    :func:`compute_presolve_changes`.
    """
    changes = compute_presolve_changes(general_form, mip_safe=mip_safe)
    gf = general_form

    variable_indices_only = [j for j, _ in changes.removed_variables]

    # update_values_that_remain (general_form/mod.rs:423-452)
    for i, value in changes.b.items():
        gf.b[i] = value
    for i, constraint_type in changes.constraints:
        gf.constraint_types[i] = constraint_type
    gf.fixed_cost += changes.fixed_cost
    for j, removed in changes.removed_variables:
        original_index = gf.from_active_to_original[j]
        name = gf.original_variables[original_index][0]
        gf.original_variables[original_index] = (name, removed)
    for (j, direction), value in changes.bounds.items():
        variable = gf.variables[j]
        if direction is BoundDirection.LOWER:
            variable.lower_bound = value
        else:
            variable.upper_bound = value

    # remove_rows_and_columns (general_form/mod.rs:463-496)
    constraints_removed = sorted(changes.constraints_marked_removed)
    variables_removed = sorted(variable_indices_only)

    gf.constraints.remove_columns(variables_removed)
    for j in reversed(variables_removed):
        del gf.variables[j]
        del gf.from_active_to_original[j]
    for new_index, original in enumerate(gf.from_active_to_original):
        name, entry = gf.original_variables[original]
        from relp_tpu_torch.data.general_form import Active

        assert isinstance(entry, Active), "free splits happen after presolve"
        gf.original_variables[original] = (name, Active(new_index))

    gf.constraints.remove_rows(constraints_removed)
    for i in reversed(constraints_removed):
        del gf.constraint_types[i]
        del gf.b[i]

    assert gf.is_consistent()

    gf.compute_solution_where_possible()
    solution = gf.get_solution()
    if solution is not None:
        raise LinearProgramError(LPStatus.FINITE_OPTIMUM, solution)
