"""MPS -> GeneralForm conversion.

Behavioral mirror of reference ``src/io/mps/convert.rs``:

* bounds are applied in order with *tightening* semantics
  (``replace_existing_with``), GLPK-style default lower bounds, and
  free-vs-bounded consistency checks;
* RANGES rows become ``Range(|r|)`` relations with ``b`` set to the interval's
  upper end depending on the original row type and the sign of r;
* multiple RHS entries take the tightest value (equal rows must agree).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from relp_tpu_torch.data.elements import (
    ConstraintRelation,
    Objective,
    RangedConstraintRelation,
    RangedKind,
    VariableType,
)
from relp_tpu_torch.data.general_form import GeneralForm, Variable
from relp_tpu_torch.io.errors import Inconsistency
from relp_tpu_torch.io.mps import MPS, BoundValue
from relp_tpu_torch.linalg.sparse import SparseColumnMatrix


def mps_to_general_form(mps: MPS) -> GeneralForm:
    variables, columns, names = _compute_variable_info(mps)
    constraint_types, b = _compute_constraint_info(mps)
    return GeneralForm(
        objective=mps.objective,
        constraints=SparseColumnMatrix(columns, mps.nr_rows()),
        constraint_types=constraint_types,
        b=b,
        variables=variables,
        variable_names=names,
        # Objective constant from an RHS entry on the cost row (GROW15/22).
        fixed_cost=mps.objective_constant,
    )


# --- variables (reference: compute_variable_info + process_bounds) ---


def _compute_variable_info(
    mps: MPS,
) -> Tuple[List[Variable], List[List[Tuple[int, Fraction]]], List[str]]:
    cost_by_column: Dict[int, Fraction] = {}
    for j, value in mps.cost_values:
        # The reference consumes only the first cost entry per column.
        cost_by_column.setdefault(j, value)

    variables: List[Variable] = []
    columns: List[List[Tuple[int, Fraction]]] = []
    names: List[str] = []
    for j, column in enumerate(mps.columns):
        variables.append(
            Variable(
                variable_type=column.variable_type,
                cost=cost_by_column.get(j, Fraction(0)),
                lower_bound=None,
                upper_bound=None,
            )
        )
        columns.append([(i, v) for i, v in column.values if v != 0])
        names.append(column.name)

    _process_bounds(variables, mps)
    return variables, columns, names


def _tighten(existing: Optional[Fraction], new: Fraction, keep_larger: bool) -> Fraction:
    """replace_existing_with semantics (convert.rs:~270)."""
    if existing is None:
        return new
    if keep_larger:
        return new if new > existing else existing
    return new if new < existing else existing


def _process_bounds(variables: List[Variable], mps: MPS) -> None:
    n = len(variables)
    needs_default_lower = [True] * n
    is_free = [False] * n

    for group in mps.bounds:
        for j, bound in group.values:
            v = variables[j]
            needs_default, free = _process_bound(bound, v)
            is_free[j] = is_free[j] or free
            needs_default_lower[j] = needs_default_lower[j] and needs_default

    for j, v in enumerate(variables):
        if is_free[j] and (v.lower_bound is not None or v.upper_bound is not None):
            raise Inconsistency("A variable is both free and bounded.")

    for j, v in enumerate(variables):
        if needs_default_lower[j] and not is_free[j]:
            assert v.lower_bound is None
            v.lower_bound = Fraction(0)


def _process_bound(bound: BoundValue, v: Variable) -> Tuple[bool, bool]:
    """Apply one bound; returns (still needs default lower, is free)."""
    kind, value = bound.kind, bound.value
    if kind == "LO":
        v.lower_bound = _tighten(v.lower_bound, value, keep_larger=True)
        return (False, False)
    if kind == "UP":
        v.upper_bound = _tighten(v.upper_bound, value, keep_larger=False)
        return (True, False)
    if kind == "FX":
        v.lower_bound = _tighten(v.lower_bound, value, keep_larger=True)
        v.upper_bound = _tighten(v.upper_bound, value, keep_larger=False)
        return (False, False)
    if kind == "FR":
        if v.lower_bound is not None or v.upper_bound is not None:
            raise Inconsistency("Variable can't be bounded and free")
        return (False, True)
    if kind == "MI":
        # Lower bound -inf is implied by lower_bound=None; the implied zero
        # upper bound becomes explicit (convert.rs: LowerMinusInfinity).
        v.upper_bound = _tighten(v.upper_bound, Fraction(0), keep_larger=False)
        return (False, False)
    if kind == "PL":
        v.lower_bound = _tighten(v.lower_bound, Fraction(0), keep_larger=True)
        return (False, False)
    if kind == "BV":
        v.lower_bound = _tighten(v.lower_bound, Fraction(0), keep_larger=True)
        v.upper_bound = _tighten(v.upper_bound, Fraction(1), keep_larger=False)
        v.variable_type = VariableType.INTEGER
        return (False, False)
    if kind == "LI":
        v.lower_bound = _tighten(v.lower_bound, value, keep_larger=True)
        v.variable_type = VariableType.INTEGER
        return (False, False)
    if kind == "UI":
        v.upper_bound = _tighten(v.upper_bound, value, keep_larger=False)
        v.variable_type = VariableType.INTEGER
        return (True, False)
    raise Inconsistency(f"Bound type {kind!r} unsupported.")


# --- constraints (reference: compute_constraint_info) ---


def _compute_constraint_info(
    mps: MPS,
) -> Tuple[List[RangedConstraintRelation], List[Fraction]]:
    nr_rows = mps.nr_rows()
    ranges = _compute_ranges(mps, nr_rows)

    # Constraint types with ranges integrated (compute_constraint_types).
    range_by_row = dict(ranges)
    constraint_types: List[RangedConstraintRelation] = []
    for i, row in enumerate(mps.rows):
        if i in range_by_row:
            r = range_by_row[i]
            if r == 0:
                constraint_types.append(RangedConstraintRelation.equal())
            else:
                constraint_types.append(RangedConstraintRelation.ranged(r))
        else:
            constraint_types.append(
                RangedConstraintRelation.from_relation(row.constraint_type)
            )

    # b values (compute_b): tightest rhs; ranged rows get the upper end.
    b: List[Optional[Fraction]] = [None] * nr_rows
    for rhs in mps.rhss:
        for i, value in rhs.values:
            if b[i] is None:
                ct = constraint_types[i]
                if ct.kind is RangedKind.RANGE:
                    r_signed = range_by_row[i]
                    row_type = mps.rows[i].constraint_type
                    if row_type is ConstraintRelation.GREATER:
                        b[i] = value + abs(r_signed)
                    elif row_type is ConstraintRelation.LESS:
                        b[i] = value
                    else:  # EQUAL
                        b[i] = value + r_signed if r_signed >= 0 else value
                else:
                    b[i] = value
            else:
                assert constraint_types[i].kind is not RangedKind.RANGE
                row_type = mps.rows[i].constraint_type
                if row_type is ConstraintRelation.EQUAL:
                    if value != b[i]:
                        raise Inconsistency(
                            f"Trivial infeasibility: a constraint can't equal both "
                            f"{b[i]} and {value}"
                        )
                elif row_type is ConstraintRelation.GREATER:
                    if value > b[i]:
                        b[i] = value
                else:
                    if value < b[i]:
                        b[i] = value

    return constraint_types, [v if v is not None else Fraction(0) for v in b]


def _compute_ranges(mps: MPS, nr_rows: int) -> List[Tuple[int, Fraction]]:
    """Flatten ranges; enforce one-range-per-row and rhs consistency
    (compute_ranges)."""
    if not mps.ranges:
        return []
    flat = [(i, r) for group in mps.ranges for i, r in group.values]
    flat.sort(key=lambda t: t[0])
    for (i1, _), (i2, _) in zip(flat, flat[1:]):
        if i1 == i2:
            raise Inconsistency("Only one range per row can be specified.")

    # Rows with multiple rhs values must agree if they carry a range.
    seen: Dict[int, Fraction] = {}
    duplicates = set()
    for rhs in mps.rhss:
        for i, v in rhs.values:
            if i in seen:
                duplicates.add(i)
            else:
                seen[i] = v
    ranged_rows = {i for i, _ in flat}
    for dup in duplicates:
        if dup in ranged_rows:
            values = [
                v for rhs in mps.rhss for i, v in rhs.values if i == dup
            ]
            if any(v != values[0] for v in values):
                raise Inconsistency(
                    "Multiple rhs values for a constraint with a range"
                )
    return flat
