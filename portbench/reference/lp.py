"""The plain reference: an exact LP solve in numpy and ``fractions``.

It shares nothing with the program under test.  A textbook primal simplex
(dense explicit inverse, Dantzig pricing with Bland's rule after a run of
degenerate pivots, artificials only on rows that have no unit column) finds
a basis in floating point; the basis is then proven in exact rational
arithmetic (a sparse Gaussian elimination on the basis matrix): primal
feasible with every artificial at 0 and every reduced cost nonnegative for
an optimum, or a Farkas vector from phase 1 for infeasibility.  Where the
proof fails, exact pivots by Bland's rule continue from that basis until
it holds, so the answer is exact whatever the floating point did.

``solve(lp, precision=..., exact=False)`` is the control: the same simplex
in a lower precision, its floating-point answer reported as it is.
"""

from __future__ import annotations

from collections import defaultdict
from fractions import Fraction
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

OPTIMUM, INFEASIBLE, UNBOUNDED = "finite_optimum", "infeasible", "unbounded"

# Pivots between refactorizations of the float inverse; degenerate pivots in
# a row before Bland's rule takes over; the float pivot limit.
_REFACTOR = 50
_BLAND_AFTER = 30
_MAX_PIVOTS = 50_000
# (optimality, pivot, feasibility) tolerances by precision.
_TOL = {"float64": (1e-9, 1e-9, 1e-9), "float32": (1e-5, 1e-6, 1e-5),
        "tf32": (1e-5, 1e-6, 1e-5)}


class LP(NamedTuple):
    """minimise c.x subject to A x = b, x >= 0; ``columns[j]`` lists the
    (row, value) entries of column j; values are ints or Fractions."""

    columns: List[List[Tuple[int, object]]]
    b: List[object]
    c: List[object]


class Answer(NamedTuple):
    status: str
    objective: Optional[Fraction]  # exact (or, from the control, the float as it is)
    x: Optional[Dict[int, Fraction]]  # nonzero values by column
    float_objective: Optional[float]
    pivots: int  # float pivots
    exact_pivots: int  # exact pivots after the float basis failed its proof


def _tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (10 explicit mantissa bits), nearest, as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


class _Ops:
    """Products in the precision asked for: float64, float32, or float32
    with every product's operands rounded to TF32."""

    def __init__(self, precision: str):
        self.dtype = np.float64 if precision == "float64" else np.float32
        self.tf32 = precision == "tf32"

    def mm(self, X, Y):
        if self.tf32:
            return _tf32(X) @ _tf32(Y)
        return X @ Y

    def inv(self, B):
        return np.linalg.inv(B).astype(self.dtype)


def _float_simplex(A, b, cost, basis, allowed, locked, ops, tol):
    """Primal simplex from the feasible ``basis``.  ``allowed``: columns that
    may enter; ``locked``: columns whose basic value must stay 0 (a row
    whose locked basic column meets a nonzero pivot leaves at step 0).
    Returns (status, basis, pivots)."""
    opt_tol, piv_tol, feas_tol = tol
    m, n = A.shape
    basis = list(basis)
    pivots = degenerate = 0
    Binv = xB = None
    while pivots < _MAX_PIVOTS:
        if pivots % _REFACTOR == 0:
            Binv = ops.inv(A[:, basis].astype(np.float64))
            xB = ops.mm(Binv, b[:, None])[:, 0]
        cB = cost[basis]
        y = ops.mm(cB[None, :], Binv)[0]
        d = cost - ops.mm(y[None, :], A)[0]
        cand = allowed.copy()
        cand[basis] = False
        cand &= d < -opt_tol
        if not cand.any():
            return OPTIMUM, basis, pivots
        if degenerate > _BLAND_AFTER:
            q = int(np.flatnonzero(cand)[0])
        else:
            q = int(np.argmin(np.where(cand, d, np.inf)))
        alpha = ops.mm(Binv, A[:, q:q + 1])[:, 0]
        pos = alpha > piv_tol
        hold = locked[basis] & (np.abs(alpha) > piv_tol)
        if not (pos | hold).any():
            return UNBOUNDED, basis, pivots
        ratio = np.full(m, np.inf)
        ratio[pos] = np.maximum(xB[pos], 0) / alpha[pos]
        ratio[hold] = 0.0
        step = ratio.min()
        ties = np.flatnonzero(ratio <= step + feas_tol)
        if degenerate > _BLAND_AFTER:
            r = int(min(ties, key=lambda i: basis[i]))
        else:
            r = int(ties[np.argmax(np.abs(alpha[ties]))])
        degenerate = degenerate + 1 if step <= feas_tol else 0
        theta = xB[r] / alpha[r]
        xB = xB - theta * alpha
        xB[r] = theta
        row = Binv[r] / alpha[r]
        Binv = Binv - np.outer(alpha, row)
        Binv[r] = row
        basis[r] = q
        pivots += 1
    raise RuntimeError("reference simplex: pivot limit")


def _solve(rows: List[Dict[int, Fraction]], rhs: List[List[Fraction]]):
    """Exact solve of the square sparse system ``rows`` (row i: {column:
    value}) for each right-hand side in ``rhs``, by Gaussian elimination
    that takes the sparsest column next.  Returns one solution a
    right-hand side, as lists."""
    m = len(rows)
    rows = [dict(r) for r in rows]
    R = [[v[i] for v in rhs] for i in range(m)]
    col_rows = defaultdict(set)
    for i, row in enumerate(rows):
        for k in row:
            col_rows[k].add(i)
    remaining = set(range(m))
    order = []
    for _ in range(m):
        k = min(remaining, key=lambda kk: len(col_rows[kk]))
        if not col_rows[k]:
            raise ZeroDivisionError("singular basis")
        i = min(col_rows[k], key=lambda ii: len(rows[ii]))
        piv_row, piv = rows[i], rows[i][k]
        for i2 in col_rows[k] - {i}:
            row2 = rows[i2]
            f = row2[k] / piv
            for kk, v in piv_row.items():
                nv = row2.get(kk, 0) - f * v
                if nv:
                    if kk not in row2:
                        col_rows[kk].add(i2)
                    row2[kk] = nv
                elif kk in row2:
                    del row2[kk]
                    col_rows[kk].discard(i2)
            R[i2] = [a - f * c for a, c in zip(R[i2], R[i])]
        for kk in piv_row:
            col_rows[kk].discard(i)
        remaining.discard(k)
        order.append((i, k))
    x = [[Fraction(0)] * m for _ in rhs]
    for i, k in reversed(order):
        row = rows[i]
        for s in range(len(rhs)):
            acc = R[i][s]
            for kk, v in row.items():
                if kk != k:
                    acc -= v * x[s][kk]
            x[s][k] = acc / row[k]
    return x


class _Exact:
    """The exact data, artificials appended as unit columns."""

    def __init__(self, columns, b, n_real):
        self.columns = columns
        self.b = b
        self.n_real = n_real

    def basis_rows(self, basis):
        rows = [dict() for _ in basis]
        for k, j in enumerate(basis):
            for i, v in self.columns[j]:
                rows[i][k] = v
        return rows

    def duals(self, basis, cost):
        cols = [dict() for _ in basis]  # rows of B^T
        for k, j in enumerate(basis):
            cols[k] = {i: v for i, v in self.columns[j]}
        return _solve(cols, [[cost[j] for j in basis]])[0]

    def reduced(self, j, y, cost):
        return cost[j] - sum((y[i] * v for i, v in self.columns[j]), Fraction(0))


def _exact_simplex(E: _Exact, basis, cost, locked_from: Optional[int]):
    """Exact primal simplex by Bland's rule from an exactly feasible basis,
    over the real columns; columns from ``locked_from`` on must stay 0.
    Returns (status, basis, xB, y, pivots)."""
    basis = list(basis)
    pivots = 0
    while True:
        y = E.duals(basis, cost)
        inb = set(basis)
        q = next((j for j in range(E.n_real)
                  if j not in inb and E.reduced(j, y, cost) < 0), None)
        rows = E.basis_rows(basis)
        if q is None:
            xB = _solve(rows, [E.b])[0]
            return OPTIMUM, basis, xB, y, pivots
        col = [Fraction(0)] * len(basis)
        for i, v in E.columns[q]:
            col[i] = v
        xB, alpha = _solve(rows, [E.b, col])
        best = None
        for r, a in enumerate(alpha):
            locked = locked_from is not None and basis[r] >= locked_from
            if a > 0 or (locked and a != 0):
                ratio = Fraction(0) if locked else xB[r] / a
                key = (ratio, basis[r])
                if best is None or key < best[0]:
                    best = (key, r)
        if best is None:
            return UNBOUNDED, basis, xB, y, pivots
        basis[best[1]] = q
        pivots += 1


def _exact_state(E: _Exact, basis, cost):
    """(xB, y, the least reduced cost over the real nonbasic columns)."""
    xB = _solve(E.basis_rows(basis), [E.b])[0]
    y = E.duals(basis, cost)
    inb = set(basis)
    dmin = min((E.reduced(j, y, cost) for j in range(E.n_real) if j not in inb),
               default=Fraction(0))
    return xB, y, dmin


def solve(lp: LP, precision: str = "float64", exact: bool = True) -> Answer:
    """The LP's status and optimum.  With ``exact`` (the reference) both are
    proven in rational arithmetic; without it (the control) the float
    simplex's answer in ``precision`` is returned as it is."""
    F = Fraction
    m, n = len(lp.b), len(lp.columns)
    sign = [-1 if F(v) < 0 else 1 for v in lp.b]
    columns = [[(i, F(v) * sign[i]) for i, v in col if v] for col in lp.columns]
    b = [F(v) * sign[i] for i, v in enumerate(lp.b)]
    start: List[Optional[int]] = [None] * m
    for j, col in enumerate(columns):
        if len(col) == 1 and col[0][1] == 1 and start[col[0][0]] is None:
            start[col[0][0]] = j
    art_rows = [i for i in range(m) if start[i] is None]
    for t, i in enumerate(art_rows):
        start[i] = n + t
        columns.append([(i, F(1))])
    N = len(columns)
    ops = _Ops(precision)
    tol = _TOL[precision]
    A = np.zeros((m, N), dtype=ops.dtype)
    for j, col in enumerate(columns):
        for i, v in col:
            A[i, j] = float(v)
    bf = np.array([float(v) for v in b], dtype=ops.dtype)
    real = np.zeros(N, dtype=bool)
    real[:n] = True
    cost1 = [F(0)] * n + [F(1)] * len(art_rows)
    cost2 = [F(v) for v in lp.c] + [F(0)] * len(art_rows)
    as_float = lambda v: np.array([float(x) for x in v], dtype=ops.dtype)  # noqa: E731
    E = _Exact(columns, b, n)
    pivots = exact_pivots = 0
    basis = list(start)
    if art_rows:  # phase 1: drive the artificials to 0
        _, basis, p = _float_simplex(A, bf, as_float(cost1), basis, real,
                                     np.zeros(N, dtype=bool), ops, tol)
        pivots += p
        if not exact:
            xB = np.linalg.solve(A[:, basis].astype(np.float64), bf.astype(np.float64))
            w = float(as_float(cost1)[basis].astype(np.float64) @ xB)
            if w > tol[2] * max(1.0, float(np.abs(bf).max())):
                return Answer(INFEASIBLE, None, None, None, pivots, 0)
        else:
            xB, y, dmin = _exact_state(E, basis, cost1)
            farkas = sum((yi * bi for yi, bi in zip(y, b)), F(0))
            if dmin >= 0 and farkas > 0:
                return Answer(INFEASIBLE, None, None, None, pivots, 0)
            if not (dmin >= 0 and min(xB) >= 0):
                _, basis, xB, y, p = _exact_simplex(
                    E, basis if min(xB) >= 0 else start, cost1, None)
                exact_pivots += p
                if sum((yi * bi for yi, bi in zip(y, b)), F(0)) > 0:
                    return Answer(INFEASIBLE, None, None, None, pivots, exact_pivots)
    feasible = list(basis)  # exactly feasible, every artificial at 0
    locked = ~real
    status, basis, p = _float_simplex(A, bf, as_float(cost2), basis, real, locked,
                                      ops, tol)
    pivots += p
    # The basic values and the objective as this precision computes them.
    xf = ops.mm(ops.inv(A[:, basis].astype(np.float64)), bf[:, None])[:, 0]
    float_obj = float(ops.mm(as_float(cost2)[basis][None, :], xf[:, None])[0, 0])
    if not exact:
        if status == UNBOUNDED:
            return Answer(UNBOUNDED, None, None, None, pivots, 0)
        x = {j: F(float(v)) for j, v in zip(basis, xf) if j < n and v != 0}
        return Answer(OPTIMUM, F(float_obj), x, float_obj, pivots, 0)
    xB, y, dmin = _exact_state(E, basis, cost2)
    feasible_now = min(xB) >= 0 and all(v == 0 for j, v in zip(basis, xB) if j >= n)
    if status != OPTIMUM or not (feasible_now and dmin >= 0):
        status, basis, xB, y, p = _exact_simplex(
            E, basis if feasible_now else feasible, cost2, n)
        exact_pivots += p
    if status == UNBOUNDED:
        return Answer(UNBOUNDED, None, None, float_obj, pivots, exact_pivots)
    objective = sum((cost2[j] * v for j, v in zip(basis, xB)), F(0))
    x = {j: v for j, v in zip(basis, xB) if j < n and v != 0}
    return Answer(OPTIMUM, objective, x, float_obj, pivots, exact_pivots)


def check_point(lp: LP, x: Dict[int, Fraction]) -> bool:
    """Whether ``x`` (nonzero values by column) satisfies A x = b and x >= 0
    exactly."""
    if any(v < 0 for v in x.values()):
        return False
    acc = [Fraction(0)] * len(lp.b)
    for j, v in x.items():
        for i, a in lp.columns[j]:
            acc[i] += a * v
    return all(a == Fraction(bi) for a, bi in zip(acc, lp.b))
