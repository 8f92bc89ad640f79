"""Debug pretty-printers.

Analog of the reference's Display impls for Tableau / Carry / MatrixData
(tableau/mod.rs:359-441, carry/mod.rs:715-734, matrix_data.rs:694-742) — the
reference's only observability surface.
"""

from __future__ import annotations

import numpy as np


def format_state(state, max_rows: int = 16) -> str:
    """Human-readable snapshot of a device simplex state."""
    basis = np.asarray(state.basis)
    xB = np.asarray(state.xB)
    lines = [
        f"iteration={int(state.iteration)} status={int(state.status)} "
        f"obj={float(state.obj):.10g} degen={int(state.degen_count)}",
        f"{'row':>5s} {'basis col':>10s} {'value':>16s}",
    ]
    for i in range(min(len(basis), max_rows)):
        lines.append(f"{i:>5d} {int(basis[i]):>10d} {float(xB[i]):>16.8g}")
    if len(basis) > max_rows:
        lines.append(f"  ... ({len(basis) - max_rows} more rows)")
    return "\n".join(lines)


def validate_bfs_state(state, A, b, c, *, feas_tol: float = 1e-5) -> None:
    """Runtime basic-feasible-solution invariant check.

    Analog of the reference's debug-build validator
    ``debug_assert_in_basic_feasible_solution_state`` (tableau/mod.rs:319-357),
    which at the top of every simplex iteration regenerates every basis column
    and checks B^-1 B = I, zero reduced costs on basic columns, and b_bar >= 0.
    Here the check runs on the host at refactorization boundaries when
    ``SolverConfig.debug_validate`` is set (every-iteration checking would
    serialize the device loop).

    Raises ``AssertionError`` with a diagnostic message on violation.
    """
    basis = np.asarray(state.basis)
    Binv = np.asarray(state.Binv, dtype=np.float64)
    xB = np.asarray(state.xB, dtype=np.float64)
    pi = np.asarray(state.pi, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)

    B = A[:, basis]
    m = B.shape[0]
    # Tolerances scale with the working dtype of the carried inverse.
    eps = 1e-4 if np.asarray(state.Binv).dtype == np.float32 else 1e-8
    scale = 1.0 + np.abs(B).max()

    resid = np.abs(Binv @ B - np.eye(m)).max()
    assert resid <= eps * scale * m, (
        f"BFS invariant violated: ||Binv @ B - I||_inf = {resid:.3g} "
        f"(tol {eps * scale * m:.3g})"
    )
    neg = float(xB.min())
    assert neg >= -feas_tol * scale, (
        f"BFS invariant violated: basic value {neg:.3g} < -{feas_tol:.3g} "
        "(b_bar >= 0 fails)"
    )
    dB = np.abs(c[basis] - pi @ B).max()
    assert dB <= eps * scale * m, (
        f"BFS invariant violated: max |reduced cost on basic column| = "
        f"{dB:.3g} (should be 0, tol {eps * scale * m:.3g})"
    )
    obj = float(c[basis] @ xB)
    drift = abs(obj - float(state.obj))
    assert drift <= eps * (1.0 + abs(obj)) * m, (
        f"BFS invariant violated: carried objective {float(state.obj):.10g} "
        f"vs cB@xB {obj:.10g}"
    )


def format_problem(problem, max_cols: int = 12) -> str:
    """Summary of a lowered DeviceProblem."""
    return (
        f"DeviceProblem M={problem.M} N={problem.N} "
        f"(real {problem.m_real}x{problem.n_real}, artificials at "
        f"{problem.art_offset}); nnz={np.count_nonzero(problem.A)}; "
        f"equilibrated={problem.col_scale is not None}"
    )
