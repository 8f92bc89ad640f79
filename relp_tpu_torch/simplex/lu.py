"""LU + eta-file basis inverse: the port of ``relp_tpu.simplex.lu``.

The same backend as the JAX package's (the reference's LUDecomposition +
eta files): a pivoted dense LU of the basis in f32 (``torch.linalg.
lu_factor_ex``), FTRAN/BTRAN as triangular solves plus one refinement step
in the carry dtype, and a fixed-capacity ring of product-form etas, each
pivot appending (w, r), so that ``B_k = B_0 E_1 ... E_k``.  The ring's
capacity (``refactor_period``) sets the refactorization cadence.

Differences from the JAX code, and why:

* ``piv`` holds torch's 1-based LAPACK row swaps; ``jax.scipy.linalg.
  lu_factor`` returns 0-based ones.  ``state_from_numpy`` and
  ``state_to_numpy`` convert, so both packages can start from one state.
* A chunk is a fixed number of iterations with a device-side ``active``
  mask, as in ``kernels.run_chunk``; the JAX while-loop's exits (status,
  the ring-full ``eta_count < capacity`` and ``stop_at_zero``) fold into
  the mask, and on the CPU the loop stops at the first inactive iteration.
* The JAX eta loops run all ``capacity`` slots under ``lax.cond(k <
  eta_count)``.  Here a loop runs only the slots that can be in use: at
  iteration i of a chunk that started with e etas, at most e + i.  A slot
  past the live count is a masked identity, so the bits are those of the
  full masked loop.
* The ring is written in place on the chunk's own copy of it, and a slot
  keeps its old value unless the pivot is taken; the index of the write is
  clamped into the ring, so a full ring (where no pivot is taken) is never
  written out of range.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple

import numpy as np
import torch

from relp_tpu_torch.simplex.kernels import (
    PRICE_STEEPEST,
    _at,
    _select_entering,
    _select_leaving,
    _status,
)
from relp_tpu_torch.simplex.state import OPTIMAL, RUNNING, UNBOUNDED


class LUState(NamedTuple):
    """Solver state with LU factors + eta ring instead of an explicit inverse."""

    lu: torch.Tensor  # (M, M) packed LU factors of B0 (f32)
    piv: torch.Tensor  # (M,) int32, 1-based LAPACK row swaps (torch's convention)
    B0: torch.Tensor  # (M, M) the refactorization-time basis matrix (carry dtype)
    eta_vals: torch.Tensor  # (K, M) product-form update columns w
    eta_rows: torch.Tensor  # (K,) int32 pivot rows
    eta_count: torch.Tensor  # () int32
    basis: torch.Tensor  # (M,) int32
    xB: torch.Tensor  # (M,)
    pi: torch.Tensor  # (M,)
    obj: torch.Tensor  # ()
    in_basis: torch.Tensor  # (N,) bool
    gamma: torch.Tensor  # (N,)
    iteration: torch.Tensor  # () int32
    status: torch.Tensor  # () int32
    inner: torch.Tensor  # () int32
    price_start: torch.Tensor  # () int32: round-robin pricing resume point


def state_from_numpy(fields: Any, device) -> LUState:
    """A port LU state from numpy-convertible fields: a mapping of the 16
    field names or an object carrying them, such as the JAX package's
    ``LUState`` (whose 0-based ``piv`` becomes 1-based here)."""
    if isinstance(fields, Mapping):
        get = fields.__getitem__
    else:
        get = lambda name: getattr(fields, name)  # noqa: E731
    out = {}
    for name in LUState._fields:
        value = np.array(get(name))
        if name == "piv":
            value = (value + 1).astype(np.int32)
        out[name] = torch.as_tensor(value, device=device)
    return LUState(**out)


def state_to_numpy(state: LUState) -> Dict[str, np.ndarray]:
    """The state's fields as host numpy arrays, ``piv`` 0-based as the JAX
    package keeps it."""
    out = {name: getattr(state, name).detach().cpu().numpy() for name in LUState._fields}
    out["piv"] = (out["piv"] - 1).astype(np.int32)
    return out


def _solve32(lu, piv, rhs, trans: int):
    """The f32 factors applied to ``rhs`` (a vector or a matrix of columns):
    B0 x = rhs (trans=0) or B0^T x = rhs (trans=1)."""
    vector = rhs.dim() == 1
    rhs32 = rhs.to(torch.float32)
    x = torch.linalg.lu_solve(
        lu, piv, rhs32.unsqueeze(-1) if vector else rhs32, adjoint=trans == 1
    )
    return x.squeeze(-1) if vector else x


def _lu_solve(lu, piv, B0, rhs, trans: int, refine: bool = True):
    """Solve B0 x = rhs (trans=0) or B0^T x = rhs (trans=1) with the f32
    factors plus one refinement step in rhs's dtype."""
    x = _solve32(lu, piv, rhs, trans).to(rhs.dtype)
    if refine:
        residual = rhs - (torch.matmul(B0, x) if trans == 0 else torch.matmul(B0.T, x))
        x = x + _solve32(lu, piv, residual, trans).to(rhs.dtype)
    return x


def _live(eta_count, steps: int, device) -> torch.Tensor:
    """(steps,) bool: slot k holds a live eta (k < eta_count)."""
    return torch.arange(steps, device=device) < eta_count


def _apply_etas_ftran(eta_vals, eta_rows, eta_count, x, steps: int):
    """x <- E_k^-1 ... E_1^-1 x over the first ``steps`` slots; a slot past
    ``eta_count`` is skipped.  E = I + (w - e_r) e_r^T, so E^-1 x =
    x - (x_r / w_r)(w - e_r)."""
    if steps == 0:
        return x
    live = _live(eta_count, steps, x.device)
    rows = eta_rows.to(torch.int64)
    for k in range(steps):
        w, r1 = eta_vals[k], rows[k : k + 1]
        factor = x.index_select(0, r1) / w.index_select(0, r1)
        new = x - factor * w
        new.index_copy_(0, r1, factor)
        x = torch.where(live[k], new, x)
    return x


def _apply_etas_btran(eta_vals, eta_rows, eta_count, y, steps: int):
    """y <- y E_k^-1 ... E_1^-1 (row form), newest eta first; only entry r
    moves: y'_r = y_r - (y.w - y_r) / w_r."""
    if steps == 0:
        return y
    live = _live(eta_count, steps, y.device)
    rows = eta_rows.to(torch.int64)
    for k in reversed(range(steps)):
        w, r1 = eta_vals[k], rows[k : k + 1]
        y_r = y.index_select(0, r1)
        new_r = y_r - (torch.matmul(y, w) - y_r) / w.index_select(0, r1)
        y = y.index_copy(0, r1, torch.where(live[k], new_r, y_r))
    return y


def lu_ftran(state: LUState, a, steps: int):
    """w = B^-1 a through the factors and the first ``steps`` ring slots."""
    x = _lu_solve(state.lu, state.piv, state.B0, a, trans=0)
    return _apply_etas_ftran(state.eta_vals, state.eta_rows, state.eta_count, x, steps)


def lu_btran(state: LUState, y, steps: int):
    """v = y B^-1 (row form) through the ring's first ``steps`` slots and the
    factors."""
    y = _apply_etas_btran(state.eta_vals, state.eta_rows, state.eta_count, y, steps)
    return _lu_solve(state.lu, state.piv, state.B0, y, trans=1)


def lu_refactorize(A, b, c, basis, *, eta_capacity: int):
    """Fresh LU factors of the current basis and an empty eta ring.

    Returns (lu, piv, B0, eta_vals, eta_rows, xB, pi, obj, residual) with
    residual = max|B xB - b| / (1 + max|b|); a singular basis gives a
    non-finite or large residual (``lu_factor_ex`` does not raise).
    """
    M = A.shape[0]
    basis64 = basis.to(torch.int64)
    B = A.index_select(1, basis64)
    lu, piv, _info = torch.linalg.lu_factor_ex(B.to(torch.float32))
    eta_vals = torch.zeros((eta_capacity, M), dtype=A.dtype, device=A.device)
    eta_rows = torch.zeros((eta_capacity,), dtype=torch.int32, device=A.device)
    xB = _lu_solve(lu, piv, B, b, trans=0)
    cB = c.index_select(0, basis64)
    pi = _lu_solve(lu, piv, B, cB, trans=1)
    obj = torch.matmul(cB, xB)
    residual = (torch.matmul(B, xB) - b).abs().max() / (1.0 + b.abs().max())
    return lu, piv, B, eta_vals, eta_rows, xB, pi, obj, residual


def _e(r: torch.Tensor, M: int, dtype, device) -> torch.Tensor:
    """The unit vector e_r for a 0-d index tensor r."""
    return torch.zeros(M, dtype=dtype, device=device).index_fill_(0, r.reshape(1), 1.0)


def _lu_iteration(
    state: LUState, A_scan, A_full, c, c_scan, candidate_mask, active, steps: int,
    *, pricing: int, opt_tol: float, pivot_tol: float,
) -> LUState:
    """One simplex pivot on the LU + eta state (the JAX package's
    ``make_lu_iteration``), written to the ring in place: the chunk passes
    its own copy.  ``steps`` bounds the live ring slots before this pivot."""
    M, N = A_scan.shape
    K = state.eta_vals.shape[0]
    scan_dtype = A_scan.dtype
    low_precision_scan = scan_dtype != A_full.dtype

    d = c_scan - torch.matmul(state.pi.to(scan_dtype), A_scan)
    if low_precision_scan:
        noise = float(torch.finfo(scan_dtype).eps) * 8.0
        threshold = opt_tol + noise * (1.0 + state.pi.abs().max()).to(scan_dtype)
    else:
        threshold = opt_tol
    eligible = candidate_mask & ~state.in_basis & (d < -threshold)
    gamma = state.gamma.to(scan_dtype)
    q, any_eligible = _select_entering(
        d, gamma, eligible, pricing, N, start=state.price_start
    )
    q1 = q.reshape(1)

    a_q = A_full.index_select(1, q1).reshape(M)
    w = lu_ftran(state, a_q, steps)
    d_q_full = _at(c, q) - torch.matmul(state.pi, a_q)
    if low_precision_scan:
        any_eligible = any_eligible & (d_q_full < -opt_tol)

    r, any_positive = _select_leaving(state.xB, w, state.basis, pricing, pivot_tol)
    new_status = _status(
        (~any_eligible, OPTIMAL), (~any_positive, UNBOUNDED), default=RUNNING
    )
    do_pivot = (new_status == RUNNING) & active

    r1 = r.reshape(1)
    w_r = _at(w, r)
    safe_w_r = torch.where(do_pivot, w_r, 1.0)
    t = torch.clamp_min(_at(state.xB, r), 0.0) / safe_w_r
    xB_new = state.xB - t * w
    xB_new.index_copy_(0, r1, t.reshape(1))

    leaving = _at(state.basis, r).to(torch.int64).reshape(1)
    basis_new = state.basis.clone().index_copy_(0, r1, q1.to(torch.int32))
    in_basis_new = (
        state.in_basis.clone().index_fill_(0, leaving, False).index_fill_(0, q1, True)
    )

    # Append the eta (w, r) at slot eta_count, in place on the chunk's copy
    # of the ring; without a pivot the slot keeps its value.
    slot = torch.clamp_max(state.eta_count, K - 1).to(torch.int64).reshape(1)
    kept = state.eta_vals.index_select(0, slot).reshape(M)
    state.eta_vals.index_copy_(0, slot, torch.where(do_pivot, w, kept).reshape(1, M))
    kept_r = state.eta_rows.index_select(0, slot)
    state.eta_rows.index_copy_(0, slot, torch.where(do_pivot, r1.to(torch.int32), kept_r))
    eta_count_new = state.eta_count + do_pivot.to(torch.int32)

    # Duals: pi' = pi + d_q rho_r with rho_r = e_r B_new^-1, BTRAN of e_r
    # through the ring with the new eta.
    e_r = _e(r, M, A_full.dtype, A_full.device)
    rho_new = lu_btran(state._replace(eta_count=state.eta_count + 1), e_r, min(K, steps + 1))
    pi_new = state.pi + d_q_full * rho_new
    obj_new = torch.matmul(c.index_select(0, basis_new.to(torch.int64)), xB_new)

    if pricing == PRICE_STEEPEST:
        gamma_q_val = (1.0 + torch.matmul(w, w)).to(scan_dtype)
        v = lu_btran(state, w, steps).to(scan_dtype)  # the OLD inverse
        abar = torch.matmul(rho_new.to(scan_dtype), A_scan)
        inner = torch.matmul(v, A_scan)
        gamma_new = gamma - 2.0 * abar * inner + (abar * abar) * gamma_q_val
        gamma_new = torch.maximum(gamma_new, 1.0 + abar * abar)
        gamma_new.index_copy_(
            0,
            leaving,
            torch.clamp_min(
                gamma_q_val / (safe_w_r * safe_w_r).to(scan_dtype), 1.0
            ).reshape(1),
        )
        gamma_new.index_fill_(0, q1, 1.0)
        gamma_new = gamma_new.to(state.gamma.dtype)
    else:
        gamma_new = state.gamma

    def select(new, old):
        return torch.where(do_pivot, new, old)

    return state._replace(
        eta_count=eta_count_new,
        basis=select(basis_new, state.basis),
        xB=select(xB_new, state.xB),
        pi=select(pi_new, state.pi),
        obj=select(obj_new, state.obj),
        in_basis=select(in_basis_new, state.in_basis),
        gamma=select(gamma_new, state.gamma),
        iteration=state.iteration + do_pivot.to(torch.int32),
        status=torch.where(active, new_status, state.status),
        inner=state.inner + active.to(torch.int32),
        price_start=select((q + 1) % N, state.price_start).to(torch.int32),
    )


def lu_run_chunk(
    state: LUState,
    A_scan,
    A_full,
    c,
    candidate_mask,
    *,
    pricing: int,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    degen_tol: float,
    stop_at_zero: bool = False,
) -> LUState:
    """Run pivots until the eta ring fills, the chunk budget is spent, or the
    phase terminates; one host read (the ring's fill) per chunk."""
    K = state.eta_vals.shape[0]
    state = state._replace(
        inner=torch.zeros((), dtype=torch.int32, device=c.device),
        eta_vals=state.eta_vals.clone(),
        eta_rows=state.eta_rows.clone(),
    )
    c_scan = c.to(A_scan.dtype)
    eta0 = int(state.eta_count)
    on_cpu = A_scan.device.type == "cpu"
    for i in range(chunk):
        active = (state.status == RUNNING) & (state.eta_count < K)
        if stop_at_zero:
            active = active & (state.obj > 1e-9)
        if on_cpu and not bool(active):
            break
        state = _lu_iteration(
            state, A_scan, A_full, c, c_scan, candidate_mask, active,
            min(K, eta0 + i), pricing=pricing, opt_tol=opt_tol, pivot_tol=pivot_tol,
        )
    return state
