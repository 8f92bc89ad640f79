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
* A chunk is a loop of torch ops; on a card it is captured once as a CUDA
  graph and replayed (``simplex/graphs.py``), under a mesh with the grid's
  reductions (``_Grid``, a static argument of the chunk) captured as its
  all_reduces; on the CPU, and so under gloo, it runs eagerly.  Its carry
  (``PdhgCarry``) holds the Halpern counter ``k0`` and the step sizes as
  0-d device tensors, as the JAX chunk traces them as arrays, so one graph
  serves every chunk and restart.  The Halpern weights ``(k0+i+1)/(k0+i+2)`` are divided in f64
  on the device from exact integers and cast to ``A.dtype``, as the JAX
  chunk forms each in its default float type and casts it.
* ``mesh`` shards A in 2-D, rows over "batch" and columns over "col",
  zero-padded to equal shards as in the JAX package; the reductions that
  GSPMD inserts there are written out (``_Grid``): ``A x`` is summed over
  the column group, ``y A`` over the row group, and the norms and dot
  products behind the KKT residuals and the restart decisions are reduced,
  so every rank decides alike.  The ``row_axis``/``col_axis`` arguments
  are not kept: the axes are the mesh's "batch" and "col".
* The scaling is a function of its own (``scale_problem``), so that a
  check can rebuild the iterated system from the same inputs.
* ``solve_first_order`` also attaches the PDHG statistics to the result
  (``result.first_order_stats``).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from relp_tpu_torch.config import SolverConfig, default_config, torch_device
from relp_tpu_torch.simplex import graphs


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


class _Local:
    """The reductions of one device: a plain matvec, norm and dot."""

    @staticmethod
    def Ax(A, x):
        return torch.matmul(A, x)

    @staticmethod
    def yA(y, A):
        return torch.matmul(y, A)

    @staticmethod
    def norm_rows(v):
        return torch.linalg.vector_norm(v)

    norm_cols = norm_rows

    @staticmethod
    def dot_rows(a, b):
        return torch.matmul(a, b)

    dot_cols = dot_rows

    @staticmethod
    def sum_cols(v):
        return torch.sum(v)


class _Grid:
    """The reductions of a 2-D sharded A (rows over the mesh's "batch"
    axis, columns over "col"): each rank holds block (i, j) of A, block j of
    x, c, u and block i of y, b; a sum over columns is an all_reduce over
    the ranks of the same row block (the "col" group), a sum over rows one
    over the "batch" group."""

    def __init__(self, mesh):
        from relp_tpu_torch.parallel.sharded import _group

        self.rows, self.n_r, self.i = _group(mesh, "batch")
        self.cols, self.n_c, self.j = _group(mesh, "col")

    @staticmethod
    def _sum(t, group):
        from relp_tpu_torch.parallel.sharded import all_reduce

        return all_reduce(t, group)

    def Ax(self, A, x):
        return self._sum(torch.matmul(A, x), self.cols)

    def yA(self, y, A):
        return self._sum(torch.matmul(y, A), self.rows)

    def norm_rows(self, v):
        return torch.sqrt(self._sum(torch.sum(v * v), self.rows))

    def norm_cols(self, v):
        return torch.sqrt(self._sum(torch.sum(v * v), self.cols))

    def dot_rows(self, a, b):
        return self._sum(torch.matmul(a, b), self.rows)

    def dot_cols(self, a, b):
        return self._sum(torch.matmul(a, b), self.cols)

    def sum_cols(self, v):
        return self._sum(torch.sum(v), self.cols)

    def block(self, x, parts: int, index: int):
        n = x.shape[0] // parts
        return x[index * n:(index + 1) * n]

    def gather(self, v, group, parts: int):
        from relp_tpu_torch.parallel.sharded import all_gather

        return all_gather(v, group, parts).reshape(-1)


_LOCAL = _Local()


def _power_norm(A: torch.Tensor, iters: int = 30, ops=_LOCAL, v0=None) -> float:
    """Spectral norm estimate by power iteration on A'A (``v0``: this
    rank's block of the start vector on a grid)."""
    if v0 is None:
        rng = np.random.default_rng(0)
        v0 = rng.standard_normal(A.shape[1])
    v = torch.as_tensor(v0, device=A.device).to(A.dtype)
    for _ in range(iters):
        w = ops.yA(ops.Ax(A, v), A)
        v = w / torch.clamp_min(ops.norm_cols(w), 1e-30)
    return float(torch.sqrt(ops.norm_cols(ops.yA(ops.Ax(A, v), A))))


def _kkt(A, b, c, u, x, y, ops=_LOCAL) -> Tuple[float, float, float]:
    """KKT residuals for ``min c'x s.t. Ax=b, 0 <= x <= u`` (u may be inf).

    lambda = c - A'y decomposes onto the box's bound multipliers: columns
    with a finite upper bound absorb either sign, so only unbounded
    columns' negative parts are dual-infeasible; the dual objective is
    ``b'y + sum_{u_j<inf} u_j min(lambda_j, 0)`` (PDLP sec. 2)."""
    pr = float(ops.norm_rows(ops.Ax(A, x) - b)) / (1.0 + float(ops.norm_rows(b)))
    lam = c - ops.yA(y, A)
    finite_u = torch.isfinite(u)
    viol = torch.where(finite_u, 0.0, torch.clamp_min(-lam, 0.0))
    du = float(ops.norm_cols(viol)) / (1.0 + float(ops.norm_cols(c)))
    pobj = float(ops.dot_cols(c, x))
    dobj = float(
        ops.dot_rows(b, y)
        + ops.sum_cols(
            torch.where(finite_u, torch.where(u > 0, u, 0.0), 0.0)
            * torch.clamp_max(lam, 0.0)
        )
    )
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return pr, du, gap


class PdhgCarry(NamedTuple):
    """What a chunk starts from: the iterate, the Halpern anchor, the
    Halpern step counter since the last restart (0-d f64, an integer) and
    the step sizes (0-d, ``A.dtype``)."""

    x: torch.Tensor
    y: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    k0: torch.Tensor
    tau: torch.Tensor
    sigma: torch.Tensor


class PdhgChunkOut(NamedTuple):
    """The advanced iterate and the last plain PDHG iterate ``T(z)``."""

    x: torch.Tensor
    y: torch.Tensor
    x_t: torch.Tensor
    y_t: torch.Tensor


def pdhg_carry(x, y, ax, ay, k0: float, tau: float, sigma: float) -> PdhgCarry:
    """A chunk's carry from host numbers (one copy to the device each)."""
    scalar = lambda v, dtype: torch.tensor(v, dtype=dtype, device=x.device)  # noqa: E731
    return PdhgCarry(x, y, ax, ay, scalar(k0, torch.float64), scalar(tau, x.dtype),
                     scalar(sigma, x.dtype))


def _pdhg_chunk(carry: PdhgCarry, A, b, c, u, *, chunk: int, ops=_LOCAL) -> PdhgChunkOut:
    """Reflected Halpern PDHG (cuPDLPx / Lu-Yang r2HPDHG):
    ``z+ = (k+1)/(k+2) * (2 T(z) - z) + 1/(k+2) * anchor``.
    Returns the advanced state plus the last plain PDHG iterate ``T(z)``
    (the candidate whose KKT residuals are measured).  No host read and no
    host data: the body a graph captures."""
    ks = carry.k0 + torch.arange(chunk, dtype=torch.float64, device=A.device)
    lams = ((ks + 1.0) / (ks + 2.0)).to(A.dtype)
    rest = 1.0 - lams
    tau, sigma, ax, ay = carry.tau, carry.sigma, carry.ax, carry.ay
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    x, y = carry.x, carry.y
    x_t, y_t = x, y
    for i in range(chunk):
        g = c - ops.yA(y, A)
        x_t = torch.clamp(x - tau * g, min=zero, max=u)
        step = 2.0 * x_t - x
        y_t = y + sigma * (b - ops.Ax(A, step))
        x, y = (lams[i] * step + rest[i] * ax,
                lams[i] * (2.0 * y_t - y) + rest[i] * ay)
    return PdhgChunkOut(x, y, x_t, y_t)


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

    With ``mesh`` the iterated system is 2-D sharded (see ``_Grid``); call
    it on every rank of the mesh, which all return the same (x, y, stats).
    Zero padding (zero rows, zero-width ``u=0`` columns) makes every shard
    equal-sized and is exactly absorbing: padded x stays clipped at 0 and
    padded y at 0.
    """
    dev = _device_of(device)
    t0 = time.perf_counter()
    m, n = A_np.shape
    if u_np is None:
        u_np = np.full(n, np.inf)
    As, bs, cs, us, d_row, d_col = scale_problem(A_np, b_np, c_np, u_np, dtype)

    # Primal weight: tau = step/w, sigma = step*w (from the whole c and b).
    w0 = float(np.linalg.norm(cs) / max(np.linalg.norm(bs), 1e-12)) or 1.0
    ops, v0 = _LOCAL, None
    if mesh is not None:
        ops = _Grid(mesh)
        m_pad, n_pad = (-m) % ops.n_r, (-n) % ops.n_c
        if m_pad or n_pad:
            As = np.pad(As, ((0, m_pad), (0, n_pad)))
            bs = np.pad(bs, (0, m_pad))
            cs = np.pad(cs, (0, n_pad))
            us = np.pad(us, (0, n_pad))  # u=0 pins padded x at 0
        v0 = ops.block(np.random.default_rng(0).standard_normal(n + n_pad),
                       ops.n_c, ops.j)
        As = ops.block(ops.block(As, ops.n_r, ops.i).T, ops.n_c, ops.j).T
        bs = ops.block(bs, ops.n_r, ops.i)
        cs, us = ops.block(cs, ops.n_c, ops.j), ops.block(us, ops.n_c, ops.j)

    A = torch.as_tensor(np.ascontiguousarray(As), device=dev)
    b = torch.as_tensor(bs, device=dev)
    c = torch.as_tensor(cs, device=dev)
    u = torch.as_tensor(us, device=dev)

    norm_A = max(_power_norm(A, ops=ops, v0=v0), 1e-12)
    step = 0.9 / norm_A
    w = min(max(w0, 1e-4), 1e4)

    # A chunk replayed from its graph on a card, else eager.
    captured = graphs.ChunkGraphs() if dev.type in graphs.DEVICE_TYPES else None
    inputs = dict(A=A, b=b, c=c, u=u)

    def run_chunk(carry: PdhgCarry) -> PdhgChunkOut:
        if captured is not None:
            return captured.run(_pdhg_chunk, carry, inputs, chunk=chunk, ops=ops)
        return _pdhg_chunk(carry, **inputs, chunk=chunk, ops=ops)

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
        x, y, x_t, y_t = run_chunk(pdhg_carry(x, y, ax, ay, k0, tau, sigma))
        stats.iterations += chunk
        k0 += chunk

        cand = (x_t, y_t)
        cand_res = _kkt(A, b, c, u, x_t, y_t, ops)
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
            dx = float(ops.norm_cols(cand[0] - x_anchor))
            dy = float(ops.norm_rows(cand[1] - y_anchor))
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

    if mesh is not None:  # the whole (padded) x and y on every rank
        x = ops.gather(x, ops.cols, ops.n_c)
        y = ops.gather(y, ops.rows, ops.n_r)
    stats.wall_time_s = time.perf_counter() - t0
    # Undo the scaling (original x = D_c x_s, y = D_r y_s), dropping any
    # mesh padding first.
    x_out = x.to(torch.float64).cpu().numpy()[:n] * d_col
    y_out = y.to(torch.float64).cpu().numpy()[:m] * d_row
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
        dtype=dtype, mesh=mesh, device=device,
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
