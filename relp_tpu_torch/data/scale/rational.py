"""Exact rational prime-factor scaling.

Mirror of reference ``presolve/scale/rational`` (rational/mod.rs): factorize
every nonzero of the program — constraint coefficients, right-hand side,
cost coefficients and variable bounds — then per prime run the reference's
greedy optimization: alternate between improving constraint rows, the cost
row and columns (dedup FIFO queues, re-queueing affected counterparts) until
no single ±1 exponent shift reduces the total absolute exponent mass
(rational/mod.rs:175-216).

Shrinking shared prime powers keeps rational representations small — in this
framework it speeds the exact certifier's integerization (smaller
denominators -> fewer Dixon lifting digits).

Sign convention note: with our application (coefficient *= row_i * col_j,
cost *= cost_factor * col_j, bound /= col_j, b *= row_i — identical to the
reference's ``scale`` helper, scale/mod.rs:139-157) the materialization
consistent with the optimizer's objective is row_i = p^row_change,
col_j = p^col_change, cost_factor = p^cost_change.  The reference's
``combine_factors`` (rational/mod.rs:705-723) inverts the *column* sign
(positive change -> divide), which contradicts both its own application and
the objective its greedy just minimized; its unit tests only ever assert the
unapplied ``Scaling`` for nontrivial column factors, so the inconsistency is
invisible there.  We materialize the self-consistent direction (e.g. the
reference's test_scale_variable fixture yields column factor 1/19 here, 19
there) — the applied program then actually has the minimized exponent mass,
which our tests assert.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from relp_tpu_torch.data.elements import RangedKind
from relp_tpu_torch.data.general_form import GeneralForm
from relp_tpu_torch.data.presolve.queues import FifoSet
from relp_tpu_torch.linalg.sparse import SparseVector
from relp_tpu_torch.numbers.factorize import factorize_fraction


@dataclass
class Scaling:
    """reference: Scaling (scale/mod.rs:88-96)."""

    cost_factor: Fraction
    constraint_row_factors: List[Fraction]
    constraint_column_factors: List[Fraction]

    def scale_back_solution(self, vector: SparseVector) -> None:
        """x_j *= col_j (reference: Scaling::scale_back)."""
        assert vector.length == len(self.constraint_column_factors)
        vector.entries = [
            (j, v * self.constraint_column_factors[j]) for j, v in vector.entries
        ]


_COST_ROW = -1  # sentinel queue entry for the cost row (RowToIncrement::CostRow)


@dataclass
class _Factorization:
    """Prime-factorization tables of every nonzero of a GeneralForm
    (reference: GeneralFormFactorization, rational/mod.rs:78-112).

    Zero values are ``None`` (unaffected by scaling); nonzero values map to
    their full factorization dict — possibly empty (value 1/-1), because
    factor-free nonzeros still count as ballast in the optimization (they
    *gain* a factor under any shift).
    """

    primes: List[int]
    b: List[Optional[Dict[int, int]]]
    c: List[Optional[Dict[int, int]]]
    bounds: List[Tuple[Optional[Dict[int, int]], Optional[Dict[int, int]]]]
    # Column-major [(row, factorization)] like the constraint store.
    constraints: List[List[Tuple[int, Dict[int, int]]]]


def _factorize_general_form(gf: GeneralForm) -> _Factorization:
    """reference: GeneralForm::factorize (rational/mod.rs:595-648)."""
    primes: set = set()

    def fact(v: Fraction) -> Optional[Dict[int, int]]:
        if v == 0:
            return None
        f = factorize_fraction(v)
        primes.update(f)
        return f

    b = [fact(v) for v in gf.b]
    c = []
    bounds = []
    for var in gf.variables:
        c.append(fact(var.cost))
        lo = fact(var.lower_bound) if var.lower_bound is not None else None
        up = fact(var.upper_bound) if var.upper_bound is not None else None
        bounds.append((lo, up))
    constraints = [
        [(i, fact(v)) for i, v in col] for col in gf.constraints.columns
    ]
    return _Factorization(
        primes=sorted(primes), b=b, c=c, bounds=bounds, constraints=constraints
    )


def _count_positive(e_total: int, on: List[int], weight: int = 1) -> None:
    """Penalty deltas of a +1/-1 shift for a multiplied entry
    (reference: count_positive, rational/mod.rs:466-487)."""
    if e_total < 0:
        on[0] -= weight
        on[1] += weight
    elif e_total == 0:
        on[0] += weight
        on[1] += weight
    else:
        on[0] += weight
        on[1] -= weight


def _count_negative(e_total: int, on: List[int], weight: int = 1) -> None:
    """Same for a divided entry — variable bounds
    (reference: count_negative, rational/mod.rs:384-407)."""
    if e_total < 0:
        on[0] += weight
        on[1] -= weight
    elif e_total == 0:
        on[0] += weight
        on[1] += weight
    else:
        on[0] -= weight
        on[1] += weight


def _solve_single(
    fact: _Factorization,
    prime: int,
    by_row: List[List[Tuple[int, Dict[int, int]]]],
) -> Tuple[int, List[int], List[int]]:
    """The greedy per-prime optimization
    (reference: solve_single, rational/mod.rs:175-216).

    Returns (cost_change, row_changes, col_changes) — exponent shifts
    minimizing sum |e + shifts| over every nonzero, to a greedy fixpoint.
    """
    nr_rows = len(fact.b)
    nr_cols = len(fact.c)
    cost_change = 0
    row_changes = [0] * nr_rows
    col_changes = [0] * nr_cols

    def e_of(f: Optional[Dict[int, int]]) -> int:
        return f.get(prime, 0) if f is not None else 0

    row_queue: FifoSet[int] = FifoSet(list(range(nr_rows)) + [_COST_ROW])
    col_queue: FifoSet[int] = FifoSet(range(nr_cols))

    def update_column(j: int) -> None:
        nonlocal cost_change
        made_change = False
        while True:
            on = [0, 0]  # penalty delta on increase / on decrease
            if fact.c[j] is not None:
                _count_positive(
                    e_of(fact.c[j]) + cost_change + col_changes[j], on
                )
            for i, f in fact.constraints[j]:
                _count_positive(e_of(f) + row_changes[i] + col_changes[j], on)
            lo, up = fact.bounds[j]
            if lo is not None:
                _count_negative(e_of(lo) - col_changes[j], on)
            if up is not None:
                _count_negative(e_of(up) - col_changes[j], on)
            assert on[0] >= 0 or on[1] >= 0
            if on[0] < 0:
                col_changes[j] += 1
            elif on[1] < 0:
                col_changes[j] -= 1
            else:
                break
            made_change = True
        if made_change:
            for i, _ in fact.constraints[j]:
                row_queue.push(i)

    def do_constraint(i: int) -> None:
        made_change = False
        while True:
            on = [0, 0]
            for j, f in by_row[i]:
                _count_positive(e_of(f) + row_changes[i] + col_changes[j], on)
            if fact.b[i] is not None:
                _count_positive(e_of(fact.b[i]) + row_changes[i], on)
            assert on[0] >= 0 or on[1] >= 0
            if on[0] < 0:
                row_changes[i] += 1
            elif on[1] < 0:
                row_changes[i] -= 1
            else:
                break
            made_change = True
        if made_change:
            for j, _ in by_row[i]:
                col_queue.push(j)

    def do_cost() -> None:
        nonlocal cost_change
        made_change = False
        while True:
            on = [0, 0]
            for j, f in enumerate(fact.c):
                if f is not None:
                    _count_positive(e_of(f) + cost_change + col_changes[j], on)
            assert on[0] >= 0 or on[1] >= 0
            if on[0] < 0:
                cost_change += 1
            elif on[1] < 0:
                cost_change -= 1
            else:
                break
            made_change = True
        if made_change:
            for j, f in enumerate(fact.c):
                if f is not None:
                    col_queue.push(j)

    # Main loop: pick from whichever queue is largest relative to its
    # maximum size (reference: constraint_or_variable,
    # rational/mod.rs:223-241; ties go to the column queue).
    while row_queue or col_queue:
        take_column = bool(col_queue) and (
            not row_queue
            or len(row_queue) * nr_cols <= len(col_queue) * nr_rows
        )
        if take_column:
            update_column(col_queue.pop())
        else:
            item = row_queue.pop()
            if item == _COST_ROW:
                do_cost()
            else:
                do_constraint(item)

    return cost_change, row_changes, col_changes


def scale_general_form(gf: GeneralForm) -> Scaling:
    """Compute and apply an exact prime-power scaling in place
    (reference: Scalable::scale, rational/mod.rs:52-63)."""
    nr_rows, nr_cols = gf.nr_constraints(), gf.nr_variables()
    fact = _factorize_general_form(gf)

    by_row: List[List[Tuple[int, Dict[int, int]]]] = [
        [] for _ in range(nr_rows)
    ]
    for j, col in enumerate(fact.constraints):
        for i, f in col:
            by_row[i].append((j, f))

    cost_factor = Fraction(1)
    row_factors = [Fraction(1)] * nr_rows
    col_factors = [Fraction(1)] * nr_cols
    # Per-prime problems are independent; the reference processes largest
    # factor first (factors.pop()) — mirrored for test parity.
    for prime in reversed(fact.primes):
        cost_change, row_changes, col_changes = _solve_single(
            fact, prime, by_row
        )
        p = Fraction(prime)
        if cost_change:
            cost_factor *= p ** cost_change
        for i, s in enumerate(row_changes):
            if s:
                row_factors[i] *= p ** s
        for j, s in enumerate(col_changes):
            if s:
                col_factors[j] *= p ** s

    scaling = Scaling(cost_factor, row_factors, col_factors)
    _apply(gf, scaling, forward=True)
    return scaling


def scale_back_general_form(gf: GeneralForm, scaling: Scaling) -> None:
    """Undo a scaling in place (reference: Scalable::scale_back)."""
    _apply(gf, scaling, forward=False)


def exponent_mass(gf: GeneralForm) -> int:
    """Total absolute prime-exponent mass of every nonzero in the program —
    the quantity the scaler minimizes; exposed for tests."""
    total = 0

    def add(v: Optional[Fraction]) -> None:
        nonlocal total
        if v:
            total += sum(abs(e) for e in factorize_fraction(v).values())

    for col in gf.constraints.columns:
        for _, v in col:
            add(v)
    for v in gf.b:
        add(v)
    for var in gf.variables:
        add(var.cost)
        add(var.lower_bound)
        add(var.upper_bound)
    return total


def _apply(gf: GeneralForm, scaling: Scaling, forward: bool) -> None:
    """Forward: multiply coefficients by row*col, costs by cost*col, b and
    ranges by row; divide bounds by col.  Backward: inverse
    (reference: scale helper, scale/mod.rs:122-167)."""

    def op(value: Fraction, factor: Fraction) -> Fraction:
        return value * factor if forward else value / factor

    def inverse_op(value: Fraction, factor: Fraction) -> Fraction:
        return value / factor if forward else value * factor

    for j, column in enumerate(gf.constraints.columns):
        col_factor = scaling.constraint_column_factors[j]
        variable = gf.variables[j]
        variable.cost = op(variable.cost, scaling.cost_factor * col_factor)
        if variable.lower_bound is not None:
            variable.lower_bound = inverse_op(variable.lower_bound, col_factor)
        if variable.upper_bound is not None:
            variable.upper_bound = inverse_op(variable.upper_bound, col_factor)
        for k, (i, value) in enumerate(column):
            row_factor = scaling.constraint_row_factors[i]
            column[k] = (i, op(value, row_factor * col_factor))

    for i in range(len(gf.b)):
        row_factor = scaling.constraint_row_factors[i]
        gf.b[i] = op(gf.b[i], row_factor)
        ct = gf.constraint_types[i]
        if ct.kind is RangedKind.RANGE:
            from relp_tpu_torch.data.elements import RangedConstraintRelation

            gf.constraint_types[i] = RangedConstraintRelation.ranged(
                op(ct.range, row_factor)
            )
