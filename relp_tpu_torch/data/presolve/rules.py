"""The four presolve rules.

Mirror of reference ``presolve/rule/``: (a) fixed-variable substitution,
(b) singleton-constraint -> variable bound, (c) slack elimination via the
2x4x3 case table, (d) domain propagation via constraint activity bounds
(Achterberg 2007, algorithm 7.1).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple

from relp_tpu_torch.data.elements import (
    BoundDirection,
    LinearProgramError,
    LPStatus,
    RangedConstraintRelation,
    RangedKind,
)
from relp_tpu_torch.data.general_form import FunctionOfOthers, Solved
from relp_tpu_torch.data.presolve.index import Change, Index
from relp_tpu_torch.data.presolve.updates import BoundChange, BoundChangeKind, safe_float
from relp_tpu_torch.numbers.rational import sign


# --- rule 1: substitute fixed variable (reference: rule/fixed_variable.rs) ---


def presolve_fixed_variable(index: Index, variable: int) -> None:
    value = index.updates.is_variable_fixed(variable)
    assert value is not None
    if index.updates.mip_safe and value.denominator != 1:
        from relp_tpu_torch.data.elements import VariableType

        if index.gf.variables[variable].variable_type is VariableType.INTEGER:
            # An integer variable pinned at a fractional value: the integer
            # hull is empty (cannot happen once all bounds are rounded, but
            # original fractional fixed bounds reach here directly).
            raise LinearProgramError(LPStatus.INFEASIBLE)

    for constraint, coefficient in index.counters.iter_active_column(variable):
        index.updates.change_b(constraint, -coefficient * value)
    index.updates.fixed_cost += index.gf.variables[variable].cost * value

    rows_to_substitute = [
        i for i, _ in index.counters.iter_active_column(variable)
    ]
    for constraint in rows_to_substitute:
        index.counters.variable[variable] -= 1
        index.counters.constraint[constraint] -= 1
        index.queue_constraint_by_counter(constraint)

    index.remove_variable(variable, Solved(value))


# --- rule 2: singleton constraint -> variable bound
# (reference: rule/bound_constraint.rs) ---


def presolve_bound_constraint(index: Index, constraint: int) -> None:
    assert index.counters.constraint[constraint] == 1
    entries = list(index.counters.iter_active_row(constraint))
    assert len(entries) == 1
    variable, coefficient = entries[0]
    assert index.counters.variable[variable] != 0

    b = index.updates.b_value(constraint)
    bound_value = b / coefficient
    constraint_type = index.updates.constraint_type(constraint)
    coefficient_positive = sign(coefficient) > 0

    changes: List[Tuple[BoundDirection, Fraction]] = []
    kind = constraint_type.kind
    if (kind is RangedKind.GREATER and coefficient_positive) or (
        kind is RangedKind.LESS and not coefficient_positive
    ):
        changes.append((BoundDirection.LOWER, bound_value))
    elif (kind is RangedKind.LESS and coefficient_positive) or (
        kind is RangedKind.GREATER and not coefficient_positive
    ):
        changes.append((BoundDirection.UPPER, bound_value))
    elif kind is RangedKind.EQUAL:
        changes.append((BoundDirection.LOWER, bound_value))
        changes.append((BoundDirection.UPPER, bound_value))
    else:  # RANGE: b - r <= c*x <= b
        bound1 = (b - constraint_type.range) / coefficient
        bound2 = bound_value
        if coefficient_positive:
            changes.append((BoundDirection.LOWER, bound1))
            changes.append((BoundDirection.UPPER, bound2))
        else:
            changes.append((BoundDirection.LOWER, bound2))
            changes.append((BoundDirection.UPPER, bound1))

    index.counters.variable[variable] -= 1
    index.counters.constraint[constraint] -= 1
    index.remove_constraint(constraint)

    for direction, value in changes:
        change = index.updates.update_bound(variable, direction, value)
        if change.kind is BoundChangeKind.NEW:
            index.after_bound_change(variable, direction, None)
        elif change.kind is BoundChangeKind.SHIFT:
            index.after_bound_change(variable, direction, change.shift)

    if index.updates.variable_feasible_value(variable) is None:
        raise LinearProgramError(LPStatus.INFEASIBLE)
    index.queue_variable_by_counter(variable)


# --- rule 3: slack elimination (reference: rule/slack.rs) ---


def _removed_variable_solution(
    index: Index, constraint: int, variable: int, coefficient: Fraction
) -> FunctionOfOthers:
    """constant - <coefficients, x> form, normalized by the slack coefficient
    (reference: compute_removed_variable_solution)."""
    constant = index.updates.b_value(constraint) / coefficient
    coefficients = [
        (index.gf.from_active_to_original[j], other / coefficient)
        for j, other in index.counters.iter_active_row(constraint)
        if j != variable
    ]
    return FunctionOfOthers(constant, coefficients)


def presolve_slack(index: Index, variable: int) -> None:
    assert index.counters.variable[variable] == 1
    assert index.gf.variables[variable].cost == 0
    assert index.updates.is_variable_fixed(variable) is None

    entries = list(index.counters.iter_active_column(variable))
    assert len(entries) == 1
    constraint, coefficient = entries[0]
    constraint_type = index.updates.constraint_type(constraint)
    kind = constraint_type.kind

    lower = index.updates.variable_bound(variable, BoundDirection.LOWER)
    upper = index.updates.variable_bound(variable, BoundDirection.UPPER)
    bounds_is_none = (lower is None, upper is None)
    positive = sign(coefficient) > 0

    # Remove both row and column: slack is unbounded in the constraint's
    # "flexible" direction, or entirely free.
    remove_row_too = (
        (kind is RangedKind.GREATER and lower is not None and upper is None and positive)
        or (kind is RangedKind.LESS and lower is None and upper is not None and positive)
        or (kind is RangedKind.LESS and lower is not None and upper is None and not positive)
        or (kind is RangedKind.GREATER and lower is None and upper is not None and not positive)
        or (lower is None and upper is None)
    )
    if remove_row_too:
        solution = _removed_variable_solution(index, constraint, variable, coefficient)
        for other_variable in [
            j for j, _ in index.counters.iter_active_row(constraint)
        ]:
            index.counters.constraint[constraint] -= 1
            index.counters.variable[other_variable] -= 1
            if other_variable != variable:
                index.queue_variable_by_counter(other_variable)
        index.remove_variable(variable, solution)
        index.remove_constraint(constraint)
        return

    # Column-only removal: the constraint absorbs the slack's bound.
    # (new constraint type, bound whose value shifts b) per the case table.
    if kind is RangedKind.EQUAL and lower is not None and upper is not None:
        if positive:
            new_type = RangedConstraintRelation.ranged(coefficient * (upper - lower))
            bound = lower
        else:
            new_type = RangedConstraintRelation.ranged(coefficient * (lower - upper))
            bound = upper
    elif kind is RangedKind.RANGE and lower is not None and upper is not None:
        if positive:
            new_type = RangedConstraintRelation.ranged(
                constraint_type.range + coefficient * (upper - lower)
            )
            bound = lower
        else:
            new_type = RangedConstraintRelation.ranged(
                constraint_type.range + coefficient * (lower - upper)
            )
            bound = upper
    elif positive and lower is not None and (
        upper is None and kind in (RangedKind.LESS, RangedKind.EQUAL, RangedKind.RANGE)
        or upper is not None and kind is RangedKind.LESS
    ):
        new_type = RangedConstraintRelation.less()
        bound = lower
    elif positive and upper is not None and (
        lower is None and kind in (RangedKind.EQUAL, RangedKind.GREATER, RangedKind.RANGE)
        or lower is not None and kind is RangedKind.GREATER
    ):
        new_type = RangedConstraintRelation.greater()
        bound = upper
    elif not positive and lower is not None and (
        upper is None and kind in (RangedKind.EQUAL, RangedKind.GREATER, RangedKind.RANGE)
        or upper is not None and kind is RangedKind.GREATER
    ):
        new_type = RangedConstraintRelation.greater()
        bound = lower
    else:
        assert not positive and upper is not None
        new_type = RangedConstraintRelation.less()
        bound = upper

    change = -coefficient * bound

    if kind in (RangedKind.EQUAL, RangedKind.RANGE):
        removed: object = _removed_variable_solution(
            index, constraint, variable, coefficient
        )
    else:
        removed = Solved(bound)

    index.counters.variable[variable] -= 1
    index.remove_variable(variable, removed)

    _update_activity_queues_if_needed(index, constraint, bounds_is_none, positive)
    index.counters.constraint[constraint] -= 1
    index.queue_constraint_by_counter(constraint)

    index.updates.change_b(constraint, change)
    index.updates.constraints[constraint] = new_type


def _update_activity_queues_if_needed(
    index: Index,
    constraint: int,
    bounds_is_none: Tuple[bool, bool],
    coefficient_positive: bool,
) -> None:
    """The removed slack no longer counts toward missing activity bounds
    (reference: update_activity_queues_if_needed)."""
    lower_missing, upper_missing = bounds_is_none
    if (lower_missing and coefficient_positive) or (
        upper_missing and not coefficient_positive
    ):
        counter = index.counters.add_to_activity_counter(
            constraint, BoundDirection.LOWER, -1
        )
        if counter <= 1:
            index.queues.activity.push((constraint, BoundDirection.LOWER))
    if (upper_missing and coefficient_positive) or (
        lower_missing and not coefficient_positive
    ):
        counter = index.counters.add_to_activity_counter(
            constraint, BoundDirection.UPPER, -1
        )
        if counter <= 1:
            index.queues.activity.push((constraint, BoundDirection.UPPER))


# --- rule 4: domain propagation (reference: rule/domain_propagation.rs) ---


def presolve_domain_propagation(
    index: Index, constraint: int, direction: BoundDirection
) -> Change:
    counter = index.counters.activity_counter(constraint, direction)
    if counter == 0:
        return _for_entire_constraint(index, constraint, direction)
    if counter == 1:
        return _create_variable_bound(index, constraint, direction)
    # Conservatively requeued entries with more missing bounds are skipped
    # (the reference never enqueues these).
    return Change.NONE


def _activity_bound(index: Index, constraint: int, direction: BoundDirection) -> Fraction:
    """Activity bound over live entries; all needed variable bounds exist
    (reference: compute_activity_bound_if_needed, recomputed on demand)."""
    total = Fraction(0)
    for variable, coefficient in index.counters.iter_active_row(constraint):
        bound_direction = direction.times_sign(sign(coefficient))
        bound = index.updates.variable_bound(variable, bound_direction)
        assert bound is not None
        total += coefficient * bound
    return total


def _can_variable_rule_be_applied(
    index: Index, constraint: int, activity_direction: BoundDirection
) -> Optional[Fraction]:
    rhs = index.updates.b_value(constraint)
    constraint_type = index.updates.constraint_type(constraint)
    kind = constraint_type.kind
    if kind is RangedKind.EQUAL:
        return rhs
    if kind is RangedKind.RANGE:
        if activity_direction is BoundDirection.LOWER:
            return rhs
        return rhs - constraint_type.range
    if kind is RangedKind.LESS:
        return rhs if activity_direction is BoundDirection.LOWER else None
    return rhs if activity_direction is BoundDirection.UPPER else None


class _ConstraintUpdate:
    REMOVE = "remove"
    SET_TO_BOUND = "set_to_bound"


def _constraint_update(
    index: Index,
    constraint: int,
    bound_value: Fraction,
    direction: BoundDirection,
):
    """The 24-case activity/rhs comparison (reference: constraint_update).

    Returns None (no change), _ConstraintUpdate.REMOVE / SET_TO_BOUND, or a
    tuple (new inequality RangedKind, rhs shift).
    """
    rhs = index.updates.b_value(constraint)
    constraint_type = index.updates.constraint_type(constraint)
    kind = constraint_type.kind
    lower_dir = direction is BoundDirection.LOWER

    if lower_dir:
        if rhs < bound_value and kind in (
            RangedKind.EQUAL,
            RangedKind.RANGE,
            RangedKind.LESS,
        ):
            raise LinearProgramError(LPStatus.INFEASIBLE)
        if rhs == bound_value and kind in (RangedKind.EQUAL, RangedKind.LESS):
            return _ConstraintUpdate.SET_TO_BOUND
        if kind is RangedKind.GREATER and rhs <= bound_value:
            return _ConstraintUpdate.REMOVE
        if kind is RangedKind.RANGE and rhs > bound_value:
            lower_end = rhs - constraint_type.range
            if bound_value < lower_end:
                return None
            return (RangedKind.LESS, Fraction(0))
        return None
    # upper activity bound
    if rhs > bound_value and kind in (RangedKind.EQUAL, RangedKind.GREATER):
        raise LinearProgramError(LPStatus.INFEASIBLE)
    if rhs == bound_value and kind in (RangedKind.EQUAL, RangedKind.GREATER):
        return _ConstraintUpdate.SET_TO_BOUND
    if kind is RangedKind.LESS and rhs >= bound_value:
        return _ConstraintUpdate.REMOVE
    if kind is RangedKind.RANGE:
        if rhs == bound_value:
            return (RangedKind.GREATER, -constraint_type.range)
        if rhs > bound_value:
            lower_end = rhs - constraint_type.range
            if bound_value < lower_end:
                raise LinearProgramError(LPStatus.INFEASIBLE)
            if bound_value == lower_end:
                return _ConstraintUpdate.SET_TO_BOUND
            return (RangedKind.GREATER, -constraint_type.range)
    return None


_EPS = 2.220446049250313e-16

# The float screen is semantics-preserving (conservative error bounds; exact
# fallback on anything uncertain or firing).  The flag exists for the
# differential test pinning screened == unscreened presolve outcomes.
SCREEN_ENABLED = True


def _for_entire_constraint(
    index: Index, constraint: int, direction: BoundDirection
) -> Change:
    """Float-screened domain propagation.

    A float interval pass with conservative error bounds decides, for the
    vast majority of (constraint, direction) evaluations, that *provably
    nothing changes* — skipping the exact rational arithmetic entirely.
    Anything that provably fires or is within the error bound falls back to
    the exact path, so presolve outcomes are bit-identical to the unscreened
    implementation (GREENBEA presolve: 37 s -> ~2 s).
    """
    if not SCREEN_ENABLED:
        return _for_entire_constraint_exact(index, constraint, direction)
    updates = index.updates
    lower_dir = direction is BoundDirection.LOWER

    # --- float activity pass over the live row ---
    total = 0.0
    absum = 0.0
    terms = []
    n = 0
    for j, c in index.counters.iter_active_row(constraint):
        cf = safe_float(c)
        if cf == 0.0 or cf != cf or cf in (float("inf"), float("-inf")):
            return _for_entire_constraint_exact(index, constraint, direction)
        positive = cf > 0.0
        bound_direction = direction if positive else direction.flipped()
        bf = updates.variable_bound_f(j, bound_direction)
        # counter == 0: every needed bound exists.
        tf = cf * bf
        total += tf
        absum += abs(tf)
        terms.append((j, c, cf, tf))
        n += 1
    if not (absum < float("inf")):
        return _for_entire_constraint_exact(index, constraint, direction)
    err_act = 4.0 * _EPS * (n + 4) * absum

    rhs_f = updates.b_value_f(constraint)
    constraint_type = updates.constraint_type(constraint)
    kind = constraint_type.kind

    # --- constraint-update screen: prove the 24-case table returns None ---
    thresh = err_act + 4.0 * _EPS * (abs(rhs_f) + abs(total))
    if lower_dir:
        if not (rhs_f - total > thresh):
            return _for_entire_constraint_exact(index, constraint, direction)
        if kind is RangedKind.RANGE:
            range_f = safe_float(constraint_type.range)
            lower_end_f = rhs_f - range_f
            t2 = err_act + 4.0 * _EPS * (
                abs(rhs_f) + abs(range_f) + abs(lower_end_f) + abs(total)
            )
            if not (lower_end_f - total > t2):
                return _for_entire_constraint_exact(
                    index, constraint, direction
                )
    else:
        if not (total - rhs_f > thresh):
            return _for_entire_constraint_exact(index, constraint, direction)

    # --- variable-part applicability (kind logic is exact; values float) ---
    if kind is RangedKind.EQUAL:
        rhs_v_f = rhs_f
    elif kind is RangedKind.RANGE:
        rhs_v_f = rhs_f if lower_dir else rhs_f - safe_float(constraint_type.range)
    elif kind is RangedKind.LESS:
        rhs_v_f = rhs_f if lower_dir else None
    else:  # GREATER
        rhs_v_f = None if lower_dir else rhs_f
    if rhs_v_f is None:
        return Change.NONE

    # --- per-variable screen: prove no bound could tighten ---
    candidates = []
    for j, c, cf, tf in terms:
        positive = cf > 0.0
        new_direction = (
            direction.flipped() if positive else direction
        )
        cur_f = updates.variable_bound_f(j, new_direction)
        if cur_f is None:
            candidates.append((j, c))  # a NEW bound always fires
            continue
        num_f = rhs_v_f - (total - tf)
        err_num = err_act + 8.0 * _EPS * (
            abs(rhs_v_f) + abs(total) + abs(tf) + abs(num_f)
        )
        new_f = num_f / cf
        err_new = err_num / abs(cf) + 4.0 * _EPS * abs(new_f)
        thr = err_new + 4.0 * _EPS * abs(cur_f)
        margin = (new_f - cur_f) if new_direction is BoundDirection.LOWER else (
            cur_f - new_f
        )
        if not (margin < -thr):
            candidates.append((j, c))
    if not candidates:
        return Change.NONE

    # --- exact evaluation, restricted to the possible-improvement subset
    # (skipped variables provably produce BoundChange NONE: no state) ---
    activity_bound = _activity_bound(index, constraint, direction)
    rhs = _can_variable_rule_be_applied(index, constraint, direction)
    assert rhs is not None  # applicability depends only on the exact kind
    return _variable_part(
        index, constraint, rhs, activity_bound, direction, Change.NONE,
        targets=candidates,
    )


def _for_entire_constraint_exact(
    index: Index, constraint: int, direction: BoundDirection
) -> Change:
    most_meaningful = Change.NONE
    activity_bound = _activity_bound(index, constraint, direction)

    update = _constraint_update(index, constraint, activity_bound, direction)
    remove_constraint = False
    apply_variable_part = True
    if update is not None:
        most_meaningful = Change.MEANINGFUL
        if update == _ConstraintUpdate.REMOVE:
            remove_constraint = True
        elif update == _ConstraintUpdate.SET_TO_BOUND:
            _set_variables_to_bound(index, constraint, direction)
            remove_constraint = True
            apply_variable_part = False
        else:
            new_kind, shift = update
            index.updates.constraints[constraint] = (
                RangedConstraintRelation.less()
                if new_kind is RangedKind.LESS
                else RangedConstraintRelation.greater()
            )
            index.updates.change_b(constraint, shift)

    if apply_variable_part:
        rhs = _can_variable_rule_be_applied(index, constraint, direction)
        if rhs is not None:
            most_meaningful = _variable_part(
                index, constraint, rhs, activity_bound, direction, most_meaningful
            )

    if remove_constraint:
        index.remove_constraint_values(constraint)
        index.remove_constraint(constraint)

    return most_meaningful


def _set_variables_to_bound(
    index: Index, constraint: int, direction: BoundDirection
) -> None:
    """The activity bound meets the rhs exactly: every variable in the row is
    fixed at the bound that built the activity bound
    (reference: ConstraintUpdate::SetVariablesToBound)."""
    counters_to_update = []
    for variable, coefficient in list(index.counters.iter_active_row(constraint)):
        variable_direction = direction.times_sign(sign(coefficient))
        bound = index.updates.variable_bound(variable, variable_direction)
        assert bound is not None
        # Promote the activity-derived bound to permanent.
        key = (variable, variable_direction)
        if key in index.updates.activity_bounds:
            index.updates.bounds[key] = index.updates.activity_bounds.pop(key)
        change = index.updates.update_bound(
            variable, variable_direction.flipped(), bound
        )
        if change.kind is BoundChangeKind.NEW:
            counters_to_update.append((variable, variable_direction.flipped()))
        assert index.updates.is_variable_fixed(variable) is not None
        index.queues.substitution.push(variable)

    for variable, d in counters_to_update:
        index.update_activity_counters(variable, d)


def _variable_part(
    index: Index,
    constraint: int,
    right_hand_side: Fraction,
    activity_bound: Fraction,
    activity_direction: BoundDirection,
    made_change: Change,
    targets=None,
) -> Change:
    """Derive per-variable bounds from the activity bound.

    ``targets`` restricts the loop to a subset of the row (the float
    screen's possible-improvement candidates); iterations are independent —
    each update touches only its own variable's flipped direction, never an
    input of another iteration — so a provably-NONE subset can be skipped.
    """
    if targets is None:
        targets = list(index.counters.iter_active_row(constraint))
    for variable, coefficient in targets:
        coefficient_sign = sign(coefficient)
        new_direction = activity_direction.flipped().times_sign(coefficient_sign)
        used_bound = index.updates.variable_bound(
            variable, activity_direction.times_sign(coefficient_sign)
        )
        assert used_bound is not None
        residual = activity_bound - coefficient * used_bound
        new_value = (right_hand_side - residual) / coefficient

        change = index.updates.update_activity_variable_bound(
            variable, new_direction, new_value
        )
        if change.kind is BoundChangeKind.NEW:
            index.after_bound_change(variable, new_direction, None)
            made_change = Change.MEANINGFUL
        elif change.kind is BoundChangeKind.SHIFT:
            index.after_bound_change(variable, new_direction, change.shift)
            if made_change is not Change.MEANINGFUL:
                made_change = Change.NOT_MEANINGFUL
    return made_change


def _create_variable_bound(
    index: Index, constraint: int, activity_direction: BoundDirection
) -> Change:
    """Exactly one variable bound is missing: derive a bound for it
    (reference: create_variable_bound)."""
    right_hand_side = _can_variable_rule_be_applied(
        index, constraint, activity_direction
    )
    if right_hand_side is None:
        return Change.NONE

    total_activity = Fraction(0)
    target: Optional[Tuple[int, Fraction]] = None
    for variable, coefficient in index.counters.iter_active_row(constraint):
        bound_direction = activity_direction.times_sign(sign(coefficient))
        bound = index.updates.variable_bound(variable, bound_direction)
        if bound is None:
            target = (variable, coefficient)
        else:
            total_activity += coefficient * bound
    if target is None:
        # Counter said one bound was missing but none is: requeue as a full
        # propagation instead.
        return Change.NONE
    target_column, target_coefficient = target

    value = (right_hand_side - total_activity) / target_coefficient
    bound_direction = activity_direction.flipped().times_sign(
        sign(target_coefficient)
    )
    change = index.updates.update_activity_variable_bound(
        target_column, bound_direction, value
    )
    if change.kind is BoundChangeKind.NEW:
        index.after_bound_change(target_column, bound_direction, None)
        return Change.MEANINGFUL
    if change.kind is BoundChangeKind.SHIFT:
        index.after_bound_change(target_column, bound_direction, change.shift)
        return Change.NOT_MEANINGFUL
    return Change.NONE
