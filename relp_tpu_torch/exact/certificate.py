"""Exportable exact certificates + an independent verifier.

Beyond reference scope (the reference asserts exactness internally but has
no audit artifact).  A certificate is a JSON-serializable witness of the
solver's verdict over the *standardized provider-level* LP
``min c'x  s.t.  Ax = b, x >= 0``:

* ``finite_optimum`` — primal point x, duals y: verified by primal
  feasibility (Ax = b, x >= 0), dual feasibility (c_j - y·a_j >= 0 for
  every column j), and strong duality (c·x = y·b).  These three checks
  prove optimality of the value with NO linear solves — the verifier is
  plain rational arithmetic anyone can re-implement in ~50 lines.
* ``infeasible`` — a Farkas ray y: y·a_j <= 0 for every column while
  y·b > 0, so no x >= 0 satisfies Ax = b.
* ``unbounded`` — a feasible point x plus an improving ray r: Ar = 0,
  r >= 0, c·r < 0.

Rationals are serialized as exact ``"p/q"`` strings; certificates survive
JSON round-trips bit-for-bit.  Reference semantic anchor: the BFS-state
invariants of ``debug_assert_in_basic_feasible_solution_state``
(the original solver's src/algorithm/two_phase/tableau/mod.rs:319-357), turned
into a portable artifact.
"""

from __future__ import annotations

import json
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from relp_tpu_torch.providers.base import MatrixProvider
from relp_tpu_torch.simplex.result import OptimizationResult, SolveStatus

FORMAT = "relp_tpu-certificate-v1"


def _frac_str(v: Fraction) -> str:
    return f"{v.numerator}/{v.denominator}"


def _parse_frac(s: str) -> Fraction:
    num, _, den = s.partition("/")
    return Fraction(int(num), int(den or 1))


def _sparse_to_json(entries) -> Dict[str, str]:
    return {str(j): _frac_str(v) for j, v in entries if v != 0}


def _column_dot(provider: MatrixProvider, j: int, y: List[Fraction]) -> Fraction:
    total = Fraction(0)
    for i, v in provider.column(j).iter_entries():
        total += y[i] * v
    return total


def export_certificate(
    result: OptimizationResult, provider: MatrixProvider
) -> dict:
    """Build the certificate dict for a certified result.

    ``finite_optimum`` uses the exact data already on the result
    (``exact_bfs``/``exact_duals``); ``infeasible``/``unbounded``
    re-derive the ray from the stored final basis (one exact solve).
    Raises ``ValueError`` when the result is not certified or carries no
    exact witness.
    """
    if not result.stats.certified:
        raise ValueError("cannot export a certificate from an uncertified result")
    m = provider.nr_rows()
    n = provider.nr_columns()
    base = {
        "format": FORMAT,
        "status": result.status.name.lower(),
        "m": m,
        "n": n,
    }

    if result.status is SolveStatus.FINITE_OPTIMUM:
        if result.exact_bfs is None or result.exact_duals is None:
            raise ValueError("certified optimum lacks exact bfs/duals")
        base.update(
            objective=_frac_str(result.exact_objective),
            x=_sparse_to_json(result.exact_bfs.entries),
            y=[_frac_str(v) for v in result.exact_duals],
            basis=list(result.basis) if result.basis is not None else None,
        )
        return base

    if result.basis is None:
        raise ValueError(f"{result.status.name} result carries no basis")

    from relp_tpu_torch.exact.dixon import ExactSolver

    b = provider.right_hand_side()
    art_offset = result.art_offset

    if result.status is SolveStatus.INFEASIBLE:
        # Farkas ray = phase-1 duals of the phase-1-optimal basis
        # (artificial columns are e_i at phase-1 cost 1, real columns cost 0).
        columns, cB = [], []
        for j in result.basis:
            if art_offset is not None and j >= art_offset:
                columns.append([(j - art_offset, Fraction(1))])
                cB.append(Fraction(1))
            else:
                columns.append(provider.column(j).entries())
                cB.append(Fraction(0))
        y = ExactSolver(columns).transposed().solve(cB)
        base.update(y=[_frac_str(v) for v in y], basis=list(result.basis))
        return base

    if result.status is SolveStatus.UNBOUNDED:
        from relp_tpu_torch.exact.certify import _basis_columns, _cost_of

        columns = _basis_columns(provider, result.basis, art_offset)
        solver = ExactSolver(columns)
        x = solver.solve(b)
        cB = [_cost_of(provider, j, art_offset) for j in result.basis]
        y = solver.transposed().solve(cB)
        in_basis = set(result.basis)
        for q in range(n):
            if q in in_basis:
                continue
            entries = provider.column(q).entries()
            d = provider.cost_value(q) - sum(
                (y[i] * v for i, v in entries), Fraction(0)
            )
            if d >= 0:
                continue
            rhs = [Fraction(0)] * m
            for i, v in entries:
                rhs[i] = v
            w = solver.solve(rhs)
            if all(wi <= 0 for wi in w):
                ray = {q: Fraction(1)}
                for i, j in enumerate(result.basis):
                    if w[i] != 0:
                        ray[j] = -w[i]
                point = {
                    j: x[i]
                    for i, j in enumerate(result.basis)
                    if x[i] != 0
                    and (art_offset is None or j < art_offset)
                }
                base.update(
                    x=_sparse_to_json(point.items()),
                    ray=_sparse_to_json(ray.items()),
                    basis=list(result.basis),
                )
                return base
        raise ValueError("no improving ray found at the stored basis")

    raise ValueError(f"no certificate form for status {result.status.name}")


def verify_certificate(
    provider: MatrixProvider, cert: dict
) -> Tuple[bool, str]:
    """Independently verify a certificate against the provider's LP.

    Pure ``fractions.Fraction`` arithmetic, no linear solves, no solver
    state — deliberately re-implementable from the docstring alone.
    Returns ``(ok, reason)``; ``reason`` pinpoints the first failed check.
    Structurally malformed certificates (missing keys, non-numeric
    entries, out-of-range indexes) are REJECTED with a reason, never
    raised — a verifier must be total on adversarial input.
    """
    try:
        return _verify_certificate(provider, cert)
    except (KeyError, ValueError, TypeError, AttributeError, ZeroDivisionError) as exc:
        return False, f"malformed certificate: {type(exc).__name__}: {exc}"


def _verify_certificate(
    provider: MatrixProvider, cert: dict
) -> Tuple[bool, str]:
    if cert.get("format") != FORMAT:
        return False, f"unknown format {cert.get('format')!r}"
    m = provider.nr_rows()
    n = provider.nr_columns()
    if cert.get("m") != m or cert.get("n") != n:
        return False, (
            f"dimension mismatch: certificate {cert.get('m')}x{cert.get('n')}"
            f" vs LP {m}x{n}"
        )
    b = provider.right_hand_side()
    status = cert.get("status")

    def residual(x: Dict[int, Fraction]) -> List[Fraction]:
        r = [-bi for bi in b]
        for j, v in x.items():
            for i, a in provider.column(j).iter_entries():
                r[i] += a * v
        return r

    if status == "finite_optimum":
        x = {int(j): _parse_frac(v) for j, v in cert["x"].items()}
        y = [_parse_frac(v) for v in cert["y"]]
        if len(y) != m:
            return False, "duals have wrong length"
        if any(j < 0 or j >= n for j in x):
            return False, "x indexes out of range"
        if any(v < 0 for v in x.values()):
            return False, "primal point has a negative entry"
        r = residual(x)
        if any(ri != 0 for ri in r):
            i = next(i for i, ri in enumerate(r) if ri != 0)
            return False, f"Ax != b at row {i} (residual {r[i]})"
        for j in range(n):
            if provider.cost_value(j) - _column_dot(provider, j, y) < 0:
                return False, f"dual infeasible at column {j}"
        pobj = sum(
            (provider.cost_value(j) * v for j, v in x.items()), Fraction(0)
        )
        dobj = sum((yi * bi for yi, bi in zip(y, b)), Fraction(0))
        if pobj != dobj:
            return False, f"duality gap: c.x={pobj} vs y.b={dobj}"
        if _parse_frac(cert["objective"]) != pobj:
            return False, "declared objective differs from c.x"
        return True, "optimal: primal feasible, dual feasible, zero gap"

    if status == "infeasible":
        y = [_parse_frac(v) for v in cert["y"]]
        if len(y) != m:
            return False, "Farkas ray has wrong length"
        yb = sum((yi * bi for yi, bi in zip(y, b)), Fraction(0))
        if yb <= 0:
            return False, f"y.b = {yb} is not positive"
        for j in range(n):
            if _column_dot(provider, j, y) > 0:
                return False, f"y.a_j > 0 at column {j}"
        return True, "infeasible: Farkas ray verified"

    if status == "unbounded":
        x = {int(j): _parse_frac(v) for j, v in cert["x"].items()}
        ray = {int(j): _parse_frac(v) for j, v in cert["ray"].items()}
        if any(j < 0 or j >= n for j in x) or any(j < 0 or j >= n for j in ray):
            return False, "index out of range"
        if any(v < 0 for v in x.values()):
            return False, "feasible point has a negative entry"
        if any(v < 0 for v in ray.values()):
            return False, "ray has a negative entry"
        r = residual(x)
        if any(ri != 0 for ri in r):
            return False, "Ax != b at the feasible point"
        ar = [Fraction(0)] * m
        for j, v in ray.items():
            for i, a in provider.column(j).iter_entries():
                ar[i] += a * v
        if any(ri != 0 for ri in ar):
            return False, "A.ray != 0"
        cr = sum(
            (provider.cost_value(j) * v for j, v in ray.items()), Fraction(0)
        )
        if cr >= 0:
            return False, f"ray cost {cr} is not negative"
        return True, "unbounded: feasible point + improving ray verified"

    return False, f"unknown status {status!r}"


def save_certificate(path: str, cert: dict) -> None:
    with open(path, "w") as f:
        json.dump(cert, f, indent=1)


def load_certificate(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
