"""Restarted PDHG (PDLP-style) with crossover: the port of
``relp_tpu.firstorder.pdhg``.

The same method as the JAX package's: Ruiz + Pock-Chambolle scaling on the
host, reflected Halpern PDHG iterations on ``min c'x s.t. Ax = b, 0 <= x <=
u`` run in chunks on the device (two matvecs, a box clip and the Halpern
step per iteration), the KKT check and PDLP's three restart criteria with
the primal-weight rebalance on the host between chunks, then a crossover
basis from the PDHG point and the exact simplex finish.

Differences from the JAX code, and why:

* ``pdhg_solve`` takes its torch ``device``: ``None`` means CUDA (and
  raises without a card, like every entry point of the port); ``"cpu"``
  must be asked for.  ``solve_first_order`` passes ``torch_device(cfg)``.
* A chunk is an eager loop of torch ops.  The Halpern weights
  ``(k0+i+1)/(k0+i+2)`` of a chunk are formed on the host in f64 and cast
  to the iterate dtype once per chunk, as the JAX chunk forms each in its
  default float type and casts it to ``A.dtype``.
* ``mesh`` (row/column sharding) raises ``NotImplementedError``; its
  ``row_axis``/``col_axis`` arguments are not kept.
* The scaling is a function of its own (``scale_problem``), so that a
  check can rebuild the iterated system from the same inputs.
* ``solve_first_order`` also attaches the PDHG statistics to the result
  (``result.first_order_stats``).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from relp_tpu_torch.config import SolverConfig, default_config, torch_device


@dataclass
class FirstOrderStats:
    iterations: int = 0
    restarts: int = 0
    primal_residual: float = float("inf")  # ||Ax-b|| / (1+||b||)
    dual_residual: float = float("inf")  # ||(A'y-c)^+|| / (1+||c||)
    gap: float = float("inf")  # |c'x - b'y| / (1+|c'x|+|b'y|)
    wall_time_s: float = 0.0
    converged: bool = False


def ruiz_equilibrate(
    A: np.ndarray, iters: int = 10
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Iterative inf-norm row/column equilibration (Ruiz 2001).

    Returns (A_scaled, d_row, d_col) with A_scaled = D_r A D_c.
    """
    m, n = A.shape
    d_row = np.ones(m)
    d_col = np.ones(n)
    As = A.copy()
    for _ in range(iters):
        r = np.sqrt(np.abs(As).max(axis=1))
        c = np.sqrt(np.abs(As).max(axis=0))
        r[r == 0] = 1.0
        c[c == 0] = 1.0
        As /= r[:, None]
        As /= c[None, :]
        d_row /= r
        d_col /= c
    return As, d_row, d_col


def _power_norm(A: torch.Tensor, iters: int = 30) -> float:
    """Spectral norm estimate by power iteration on A'A."""
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(A.shape[1]), device=A.device).to(A.dtype)
    for _ in range(iters):
        w = torch.matmul(torch.matmul(A, v), A)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    return float(torch.sqrt(torch.linalg.vector_norm(torch.matmul(torch.matmul(A, v), A))))


def _kkt(A, b, c, u, x, y) -> Tuple[float, float, float]:
    """KKT residuals for ``min c'x s.t. Ax=b, 0 <= x <= u`` (u may be inf).

    lambda = c - A'y decomposes onto the box's bound multipliers: columns
    with a finite upper bound absorb either sign, so only unbounded
    columns' negative parts are dual-infeasible; the dual objective is
    ``b'y + sum_{u_j<inf} u_j min(lambda_j, 0)`` (PDLP sec. 2)."""
    norm = torch.linalg.vector_norm
    pr = float(norm(torch.matmul(A, x) - b)) / (1.0 + float(norm(b)))
    lam = c - torch.matmul(y, A)
    finite_u = torch.isfinite(u)
    viol = torch.where(finite_u, 0.0, torch.clamp_min(-lam, 0.0))
    du = float(norm(viol)) / (1.0 + float(norm(c)))
    pobj = float(torch.matmul(c, x))
    dobj = float(
        torch.matmul(b, y)
        + torch.sum(
            torch.where(finite_u, torch.where(u > 0, u, 0.0), 0.0)
            * torch.clamp_max(lam, 0.0)
        )
    )
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return pr, du, gap


def _pdhg_chunk(x, y, ax, ay, k0: float, tau: float, sigma: float, A, b, c, u,
                *, chunk: int):
    """Reflected Halpern PDHG (cuPDLPx / Lu-Yang r2HPDHG):
    ``z+ = (k+1)/(k+2) * (2 T(z) - z) + 1/(k+2) * anchor``.
    Returns the advanced state plus the last plain PDHG iterate ``T(z)``
    (the candidate whose KKT residuals are measured)."""
    lams = torch.tensor(
        [(k0 + i + 1.0) / (k0 + i + 2.0) for i in range(chunk)], dtype=torch.float64
    ).to(device=A.device, dtype=A.dtype)
    rest = 1.0 - lams
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    x_t, y_t = x, y
    for i in range(chunk):
        g = c - torch.matmul(y, A)
        x_t = torch.clamp(x - tau * g, min=zero, max=u)
        step = 2.0 * x_t - x
        y_t = y + sigma * (b - torch.matmul(A, step))
        x, y = (lams[i] * step + rest[i] * ax,
                lams[i] * (2.0 * y_t - y) + rest[i] * ay)
    return x, y, x_t, y_t


def scale_problem(A_np, b_np, c_np, u_np, dtype):
    """The system PDHG iterates on: (As, bs, cs, us) in ``dtype`` and the
    scalings (d_row, d_col) with As = D_r A D_c, x = D_c x_s, y = D_r y_s."""
    As, d_row, d_col = ruiz_equilibrate(A_np.astype(np.float64))
    # Pock-Chambolle (alpha=1) pass on top of Ruiz: D_r = diag(1/sqrt(row
    # 1-norms)), D_c = diag(1/sqrt(col 1-norms)), the PDLP default combo.
    r1 = np.sqrt(np.abs(As).sum(axis=1))
    c1 = np.sqrt(np.abs(As).sum(axis=0))
    r1[r1 == 0] = 1.0
    c1[c1 == 0] = 1.0
    As = As / r1[:, None] / c1[None, :]
    d_row = d_row / r1
    d_col = d_col / c1
    bs = (b_np.astype(np.float64) * d_row).astype(dtype)
    cs = (c_np.astype(np.float64) * d_col).astype(dtype)
    # Column scaling D_c maps x_s = x / d_col, so bounds scale as u / d_col.
    us = (u_np.astype(np.float64) / d_col).astype(dtype)
    return As.astype(dtype), bs, cs, us, d_row, d_col


def _device_of(device) -> torch.device:
    """The torch device of a direct ``pdhg_solve`` call: None means CUDA,
    which raises without a card; the config's check also turns TF32 off."""
    platform = None if device is None else torch.device(device).type
    dev = torch_device(SolverConfig(platform=platform))
    return dev if device is None else torch.device(device)


def pdhg_solve(
    A_np: np.ndarray,
    b_np: np.ndarray,
    c_np: np.ndarray,
    u_np: Optional[np.ndarray] = None,
    *,
    tol: float = 1e-6,
    max_iters: int = 100_000,
    chunk: int = 200,
    dtype=np.float32,
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, FirstOrderStats]:
    """Restarted PDHG on ``min c'x s.t. Ax=b, 0 <= x <= u``; returns
    (x, y, stats).  ``u`` entries may be +inf (default: all +inf).

    The inner chunk is ``chunk`` iterations on ``device`` (two matvecs plus
    a box projection each); the host loop checks KKT residuals on the
    per-chunk candidate and applies PDLP's restart criteria.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh (row/column-sharded PDHG) is not ported to relp_tpu_torch "
            "yet: ROADMAP.md Queue 1, item 16"
        )
    dev = _device_of(device)
    t0 = time.time()
    if u_np is None:
        u_np = np.full(A_np.shape[1], np.inf)
    As, bs, cs, us, d_row, d_col = scale_problem(A_np, b_np, c_np, u_np, dtype)

    A = torch.as_tensor(As, device=dev)
    b = torch.as_tensor(bs, device=dev)
    c = torch.as_tensor(cs, device=dev)
    u = torch.as_tensor(us, device=dev)

    norm_A = max(_power_norm(A), 1e-12)
    step = 0.9 / norm_A
    # Primal weight: tau = step/w, sigma = step*w.
    w = float(np.linalg.norm(cs) / max(np.linalg.norm(bs), 1e-12)) or 1.0
    w = min(max(w, 1e-4), 1e4)

    x = torch.zeros_like(c)
    y = torch.zeros_like(b)
    ax, ay = x, y  # Halpern anchor
    k0 = 0.0  # Halpern step counter since last restart
    stats = FirstOrderStats()
    last_restart_res = float("inf")
    best_cand, best_res = (x, y), float("inf")
    res_prev = float("inf")
    x_anchor, y_anchor = x, y

    while stats.iterations < max_iters:
        tau = step / w
        sigma = step * w
        x, y, x_t, y_t = _pdhg_chunk(x, y, ax, ay, k0, tau, sigma, A, b, c, u,
                                     chunk=chunk)
        stats.iterations += chunk
        k0 += chunk

        cand = (x_t, y_t)
        cand_res = _kkt(A, b, c, u, x_t, y_t)
        stats.primal_residual, stats.dual_residual, stats.gap = cand_res
        res = max(cand_res)
        if res < best_res:
            best_cand, best_res = cand, res
        if res <= tol:
            x, y = cand
            stats.converged = True
            break
        # PDLP's three restart criteria (sec. 3.2, on the per-chunk
        # candidate): sufficient decay (beta_sufficient = 0.2), necessary
        # decay + worsening (beta_necessary = 0.8), or an artificially
        # long epoch (0.36 * total iterations).  A restart re-anchors the
        # Halpern schedule at the best candidate of the epoch and
        # rebalances the primal weight from the observed movement.
        sufficient = res <= 0.2 * last_restart_res
        necessary = res <= 0.8 * last_restart_res and res > res_prev
        artificial = k0 >= 0.36 * stats.iterations and k0 > 4 * chunk
        res_prev = res
        if sufficient or necessary or artificial:
            cand, res = best_cand, best_res
            dx = float(torch.linalg.vector_norm(cand[0] - x_anchor))
            dy = float(torch.linalg.vector_norm(cand[1] - y_anchor))
            if dx > 1e-12 and dy > 1e-12:
                w = min(max(w * np.sqrt(dy / dx), 1e-4), 1e4)
            x, y = cand
            ax, ay = cand
            x_anchor, y_anchor = cand
            k0 = 0.0
            last_restart_res = res
            best_cand, best_res = cand, res
            res_prev = float("inf")
            stats.restarts += 1

    stats.wall_time_s = time.time() - t0
    # Undo the scaling (original x = D_c x_s, y = D_r y_s).
    x_out = x.to(torch.float64).cpu().numpy() * d_col
    y_out = y.to(torch.float64).cpu().numpy() * d_row
    return x_out, y_out, stats


def crossover_basis(A_np: np.ndarray, x: np.ndarray) -> Optional[list]:
    """Advanced basis guess from a PDHG point: greedily pick the
    largest-x columns that keep the basis numerically nonsingular (QR
    rank tracking on the float matrix), completed arbitrarily."""
    m, n = A_np.shape
    order = np.argsort(-np.abs(x))
    chosen: list = []
    # Greedy rank-revealing selection: a column joins if it enlarges the
    # rank of the chosen set (cheap incremental check via the residual).
    q = np.zeros((m, 0))
    for j in order:
        if len(chosen) == m:
            break
        col = A_np[:, j]
        if np.linalg.norm(col) < 1e-12:
            continue
        r = col - q @ (q.T @ col)
        nr = np.linalg.norm(r)
        if nr > 1e-8 * max(1.0, np.linalg.norm(col)):
            q = np.concatenate([q, (r / nr)[:, None]], axis=1)
            chosen.append(int(j))
    if len(chosen) < m:
        return None
    return chosen


def solve_first_order(
    provider,
    config: Optional[SolverConfig] = None,
    *,
    tol: float = 1e-6,
    max_iters: int = 100_000,
    chunk: int = 200,
    crossover: bool = True,
    mesh=None,
):
    """Solve a provider's LP by restarted PDHG on the config's device, then
    (optionally) cross over to the exact simplex/certification pipeline.

    With ``crossover=True`` returns the driver's certified
    :class:`OptimizationResult` (warm-started from the PDHG basis guess;
    an unusable guess falls back to a cold exact solve: correctness never
    depends on the first-order phase).  With ``crossover=False`` returns
    ``(x, y, FirstOrderStats)`` in the provider's column/row space.
    """
    cfg = config or default_config()
    device = torch_device(cfg)
    if mesh is not None:
        raise NotImplementedError(
            "mesh (row/column-sharded PDHG) is not ported to relp_tpu_torch "
            "yet: ROADMAP.md Queue 1, item 16"
        )
    dtype = np.float32 if cfg.dtype == "float32" else np.float64
    A, b, c = provider.to_arrays(dtype=np.float64)
    m = A.shape[0]
    m_s = provider.nr_constraints()

    # Split the standard form's bound rows back into a box: PDHG handles
    # ``0 <= x <= u`` by projection (one clip per iteration), which keeps
    # the iterated system at the structural rows only: smaller and better
    # conditioned than one equality row (and one slack column) per bound,
    # as the simplex lowering carries them.
    has_struct = (np.abs(A[:m_s, :]) > 0).any(axis=0)
    cols = np.flatnonzero(has_struct)
    u = np.full(len(cols), np.inf)
    from relp_tpu_torch.providers.base import BoundDirection

    bound_row_of_col = {}
    for idx, j in enumerate(cols):
        r = provider.bound_row_index(int(j), BoundDirection.UPPER)
        if r is not None:
            u[idx] = b[r]
            bound_row_of_col[int(j)] = int(r)
    A_s = A[:m_s, :][:, cols]
    b_s = b[:m_s]
    c_s = c[cols]

    x_s, y_s, stats = pdhg_solve(
        A_s, b_s, c_s, u, tol=tol, max_iters=max_iters, chunk=chunk,
        dtype=dtype, device=device,
    )
    # Lift back to the full standard form: bound-row slacks s_r = u - x_j.
    x = np.zeros(A.shape[1])
    x[cols] = x_s
    slack_col_of_row = {}
    for j in range(A.shape[1]):
        if has_struct[j]:
            continue
        entries = np.flatnonzero(np.abs(A[:, j]) > 0)
        if len(entries) == 1 and entries[0] >= m_s:
            slack_col_of_row[int(entries[0])] = j
    for j, r in bound_row_of_col.items():
        s = slack_col_of_row.get(r)
        if s is not None:
            x[s] = max(b[r] - x[j], 0.0)
    if not crossover:
        y = np.zeros(m)
        y[:m_s] = y_s
        return x, y, stats

    from relp_tpu_torch.simplex.driver import solve_relaxation

    basis = crossover_basis(A, x)
    # The crossover finish is one warm-started simplex + certification; at
    # first-order scale the dense lowering explodes, so huge sparse
    # instances go to the sparse host backend whichever device ran PDHG.
    finish_cfg = cfg
    if cfg.backend == "auto":
        M = provider.nr_rows()
        N = provider.nr_columns() + M
        nnz = sum(
            len(provider.column(j).entries())
            for j in range(provider.nr_columns())
        )
        if M * N >= 2.5e7 and nnz / (M * provider.nr_columns()) < 0.02:
            finish_cfg = dataclasses.replace(cfg, backend="host_sparse")
    result = solve_relaxation(provider, finish_cfg, warm_start_basis=basis)
    result.stats.first_order_iterations = stats.iterations  # type: ignore[attr-defined]
    result.stats.first_order_residual = max(  # type: ignore[attr-defined]
        stats.primal_residual, stats.dual_residual, stats.gap
    )
    result.first_order_stats = stats  # type: ignore[attr-defined]
    return result
