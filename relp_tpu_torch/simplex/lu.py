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
  eta_count)``, one compiled device loop.  On a card
  (``eta_ring.launches_kernel``) a pass through the ring is one launch of
  ``ops.eta_ring``'s kernels, which read the live count on the device, so
  a chunk's passes do not depend on the ring's fill at entry; a
  steepest-edge pivot's two BTRANs (rho's and the Goldfarb one, which read
  the same ring) are one launch together.  On the CPU
  the plain loops run only the slots that can be in use: at iteration i of
  a chunk that started with e etas, at most e + i.  A slot past the live
  count is a masked identity, so the bits are those of the full masked
  loop.
* The ring is written in place on the chunk's own copy of it, and a slot
  keeps its old value unless the pivot is taken; the index of the write is
  clamped into the ring, so a full ring (where no pivot is taken) is never
  written out of range.
* Column sharding (``shard``, a ``relp_tpu_torch.parallel.sharded.
  ColumnShard``) is explicit, as in ``kernels``: A, c, the mask, ``in_basis``
  and ``gamma`` hold this rank's columns and the factors, the ring and the
  carry are replicated.  Pricing and the Goldfarb products stay local; the
  entering choice and the entering column with c_q and c_B are combined
  across ranks (two collectives a pivot), and B at refactorization.
  Without one, ``kernels.LocalColumns`` gives the same interface with no
  collective.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from relp_tpu_torch.ops import eta_ring
from relp_tpu_torch.simplex.kernels import (
    PRICE_STEEPEST,
    _at,
    _select_entering,
    _select_leaving,
    _status,
    columns,
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


def lu_ftran(state: LUState, a, steps: Optional[int] = None):
    """w = B^-1 a through the factors and the ring (``eta_ring.eta_ftran``:
    its live slots on a card, else the first ``steps``, all by default)."""
    x = _lu_solve(state.lu, state.piv, state.B0, a, trans=0)
    return eta_ring.eta_ftran(state.eta_vals, state.eta_rows, state.eta_count, x, steps)


def lu_btran(state: LUState, y, steps: Optional[int] = None):
    """v = y B^-1 (row form) through the ring (``eta_ring.eta_btran``: its
    live slots on a card, else the first ``steps``, all by default) and the
    factors."""
    y = eta_ring.eta_btran(state.eta_vals, state.eta_rows, state.eta_count, y, steps)
    return _lu_solve(state.lu, state.piv, state.B0, y, trans=1)


def lu_refactorize(A, b, c, basis, *, eta_capacity: int, shard=None):
    """Fresh LU factors of the current basis and an empty eta ring.

    Returns (lu, piv, B0, eta_vals, eta_rows, xB, pi, obj, residual) with
    residual = max|B xB - b| / (1 + max|b|); a singular basis gives a
    non-finite or large residual (``lu_factor_ex`` does not raise).  With a
    ``shard``, A and c are this rank's columns and B, c_B come from their
    owners.
    """
    M = A.shape[0]
    B, cB = columns(shard, A.shape[1], A.device).basis_columns(A, c, basis)
    lu, piv, _info = torch.linalg.lu_factor_ex(B.to(torch.float32))
    eta_vals = torch.zeros((eta_capacity, M), dtype=A.dtype, device=A.device)
    eta_rows = torch.zeros((eta_capacity,), dtype=torch.int32, device=A.device)
    xB = _lu_solve(lu, piv, B, b, trans=0)
    pi = _lu_solve(lu, piv, B, cB, trans=1)
    obj = torch.matmul(cB, xB)
    residual = (torch.matmul(B, xB) - b).abs().max() / (1.0 + b.abs().max())
    return lu, piv, B, eta_vals, eta_rows, xB, pi, obj, residual


def _e(r: torch.Tensor, M: int, dtype, device) -> torch.Tensor:
    """The unit vector e_r for a 0-d index tensor r."""
    return torch.zeros(M, dtype=dtype, device=device).index_fill_(0, r.reshape(1), 1.0)


def _lu_iteration(
    state: LUState, A_scan, A_full, c, c_scan, candidate_mask, active, steps: int,
    *, pricing: int, opt_tol: float, pivot_tol: float, shard=None,
) -> LUState:
    """One simplex pivot on the LU + eta state (the JAX package's
    ``make_lu_iteration``), written to the ring in place: the chunk passes
    its own copy.  ``steps`` bounds the live ring slots before this pivot
    (the plain loops' length; the kernel route reads the live count on the
    device)."""
    M = A_scan.shape[0]
    cols = columns(shard, A_scan.shape[1], A_scan.device)
    N = cols.N
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
        d, gamma, eligible, pricing, N, start=state.price_start, shard=shard
    )
    q1 = q.reshape(1)

    a_q, c_q, cB = cols.fetch(A_full, c, q, state.basis)
    w = lu_ftran(state, a_q, steps)
    d_q_full = c_q - torch.matmul(state.pi, a_q)
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
    in_basis_new = cols.put(cols.put(state.in_basis.clone(), leaving, False), q, True)
    cB_new = cB.index_copy_(0, r1, c_q.reshape(1))  # cB is fresh

    # Append the eta (w, r) at slot eta_count, in place on the chunk's copy
    # of the ring; without a pivot the slot keeps its value.
    slot = torch.clamp_max(state.eta_count, K - 1).to(torch.int64).reshape(1)
    kept = state.eta_vals.index_select(0, slot).reshape(M)
    state.eta_vals.index_copy_(0, slot, torch.where(do_pivot, w, kept).reshape(1, M))
    kept_r = state.eta_rows.index_select(0, slot)
    state.eta_rows.index_copy_(0, slot, torch.where(do_pivot, r1.to(torch.int32), kept_r))
    eta_count_new = state.eta_count + do_pivot.to(torch.int32)

    # Duals: pi' = pi + d_q rho_r with rho_r = e_r B_new^-1, BTRAN of e_r
    # through the ring with the new eta.  Steepest edge also needs v =
    # w B_old^-1, w's BTRAN through the ring without it: both passes read
    # the ring as it is now, so they are one pair (one launch on a card,
    # two plain loops on the CPU).
    e_r = _e(r, M, A_full.dtype, A_full.device)
    ring = (state.eta_vals, state.eta_rows)
    if pricing == PRICE_STEEPEST:
        y_rho, y_w = eta_ring.eta_btran_pair(*ring, state.eta_count + 1, e_r,
                                             state.eta_count, w, min(K, steps + 1), steps)
    else:
        y_rho = eta_ring.eta_btran(*ring, state.eta_count + 1, e_r, min(K, steps + 1))
    rho_new = _lu_solve(state.lu, state.piv, state.B0, y_rho, trans=1)
    pi_new = state.pi + d_q_full * rho_new
    obj_new = torch.matmul(cB_new, xB_new)

    if pricing == PRICE_STEEPEST:
        gamma_q_val = (1.0 + torch.matmul(w, w)).to(scan_dtype)
        v = _lu_solve(state.lu, state.piv, state.B0, y_w, trans=1).to(scan_dtype)
        abar = torch.matmul(rho_new.to(scan_dtype), A_scan)
        inner = torch.matmul(v, A_scan)
        gamma_new = gamma - 2.0 * abar * inner + (abar * abar) * gamma_q_val
        gamma_new = torch.maximum(gamma_new, 1.0 + abar * abar)
        g_leaving = torch.clamp_min(
            gamma_q_val / (safe_w_r * safe_w_r).to(scan_dtype), 1.0
        )
        gamma_new = cols.put(cols.put(gamma_new, leaving, g_leaving), q, 1.0)
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
    shard=None,
    eta0: Optional[int] = None,
    early_exit: Optional[bool] = None,
) -> LUState:
    """Run pivots until the eta ring fills, the chunk budget is spent, or the
    phase terminates.  Where the passes launch the eta-ring kernels
    (``eta_ring.launches_kernel``: on a card) every
    pass runs the ring's live slots and ``eta0`` is not read.  Else
    ``eta0`` is the ring's fill at entry (``eta_count``, read on the host
    when not given): iteration i's eta loops run ``min(K, eta0 + i)``
    slots.  ``early_exit`` stops at the first inactive iteration (default:
    on the CPU), a host read an iteration; without it the chunk has no host
    read.  With a ``shard`` the column-sized inputs are this rank's block;
    the replicated carry makes every rank take the same branches."""
    K = state.eta_vals.shape[0]
    kernel_route = eta_ring.launches_kernel(state.eta_vals)
    if eta0 is None and not kernel_route:
        eta0 = int(state.eta_count)
    if early_exit is None:
        early_exit = A_scan.device.type == "cpu"
    state = state._replace(
        inner=torch.zeros((), dtype=torch.int32, device=c.device),
        eta_vals=state.eta_vals.clone(),
        eta_rows=state.eta_rows.clone(),
    )
    c_scan = c.to(A_scan.dtype)
    for i in range(chunk):
        active = (state.status == RUNNING) & (state.eta_count < K)
        if stop_at_zero:
            active = active & (state.obj > 1e-9)
        if early_exit and not bool(active):
            break
        state = _lu_iteration(
            state, A_scan, A_full, c, c_scan, candidate_mask, active,
            K if kernel_route else min(K, eta0 + i), pricing=pricing, opt_tol=opt_tol,
            pivot_tol=pivot_tol, shard=shard,
        )
    return state
