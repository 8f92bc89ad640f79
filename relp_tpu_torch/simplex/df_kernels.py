"""Double-float (two-f32) simplex carry: the port of
``relp_tpu.simplex.df_kernels``.

The carry (B^-1, x_B, pi, obj) is held as hi/lo f32 pairs and updated with
the compensated arithmetic of ``relp_tpu_torch.ops.df32``, so drift and
matvec accumulation error stay near 2^-48 while every operation is f32.
Problem data is lowered in f64 and split hi/lo.

Plain f32 stays where the JAX package keeps it: the full-width pricing and
steepest-edge scans (on the hi part of the tableau) and the gamma weights.
The steepest-edge scan ``S = [pi_hi; v; beta_hi] @ A_scan`` with its d and
gamma epilogue is the function of ``fused_price_scan``, so it goes through
that kernel, as the dense engine's iteration does.  Dense refactorization
stays on the host in f64 (a compensated Newton-Schulz step would need O(m^3)
compensated accumulation), split back into the carry.

The iteration is ``relp_tpu.simplex.df_kernels.make_df_iteration``, written
as the port's ``kernels._iteration``: a fixed-length chunk under an
``active`` mask instead of a ``while_loop`` (an inactive iteration is a
masked no-op), with single elements read by ``index_select`` and written
into tensors made in the same iteration.  Nothing here may run under
``torch.compile`` (see ``ops/df32``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from relp_tpu_torch.ops import fused_price_scan
from relp_tpu_torch.ops.df32 import (
    df_add,
    df_div,
    df_dot,
    df_from_f64,
    df_matvec,
    df_mul,
    df_sub,
    df_vecmat,
    two_prod,
)
from relp_tpu_torch.simplex.kernels import (
    PRICE_STEEPEST,
    _NOISY_F32_EPS,
    _at,
    _select_entering,
    _select_leaving,
    _status,
)
from relp_tpu_torch.simplex.state import OPTIMAL, RUNNING, UNBOUNDED


class DfMatrix(NamedTuple):
    """A matrix split as an unevaluated f32 sum ``hi + lo`` (from f64)."""

    hi: torch.Tensor
    lo: torch.Tensor


class DfVec(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


class DfSimplexState(NamedTuple):
    """Simplex state with a double-float carry.  The hi parts keep
    ``SimplexState``'s field names, so the driver's reads of status, obj,
    xB and basis work unchanged; ``*_lo`` holds the compensation terms."""

    Binv: torch.Tensor
    Binv_lo: torch.Tensor
    basis: torch.Tensor
    xB: torch.Tensor
    xB_lo: torch.Tensor
    pi: torch.Tensor
    pi_lo: torch.Tensor
    obj: torch.Tensor
    obj_lo: torch.Tensor
    in_basis: torch.Tensor
    gamma: torch.Tensor
    iteration: torch.Tensor
    status: torch.Tensor
    degen_count: torch.Tensor
    inner: torch.Tensor
    price_start: torch.Tensor
    d: torch.Tensor


def _df_iteration(
    state: DfSimplexState, A_scan, Ah, Al, ch, cl, c_scan, candidate_mask,
    active: Optional[torch.Tensor], *, pricing: int, opt_tol: float,
    pivot_tol: float, degen_tol: float, noisy: bool,
) -> DfSimplexState:
    M, N = A_scan.shape
    f32 = torch.float32

    # --- pricing on the f32 scan copy, eligibility guarded against scan
    # noise as in the mixed-precision path ---
    d = state.d
    noise = _NOISY_F32_EPS if noisy else float(torch.finfo(f32).eps) * 8.0
    threshold = opt_tol + noise * (1.0 + state.pi.abs().max())
    if noisy:
        # The chunk-entry d comes from a clean matvec: price it with the
        # plain floor.
        threshold = torch.where(
            state.inner == 0, torch.tensor(opt_tol, dtype=f32, device=d.device),
            threshold,
        )
    eligible = candidate_mask & ~state.in_basis & (d < -threshold)
    q, any_eligible = _select_entering(
        d, state.gamma, eligible, pricing, N, start=state.price_start
    )
    q1 = q.reshape(1)

    # --- FTRAN, compensated: w = B^-1 a_q at ~2^-48 ---
    a_qh = Ah.index_select(1, q1).reshape(M)
    a_ql = Al.index_select(1, q1).reshape(M)
    wh, wl = df_matvec(state.Binv, state.Binv_lo, a_qh, a_ql)

    # Accurate reduced cost of the pick; a scan-noise candidate ends the
    # chunk (the driver and the certifier decide).
    sh, sl = df_dot(state.pi, state.pi_lo, a_qh, a_ql)
    dqh, dql = df_sub(_at(ch, q), _at(cl, q), sh, sl)
    any_eligible = any_eligible & (dqh < -opt_tol)

    # --- ratio test on the (accurate) hi parts ---
    r, any_positive = _select_leaving(state.xB, wh, state.basis, pricing, pivot_tol)
    new_status = _status(
        (~any_eligible, OPTIMAL), (~any_positive, UNBOUNDED), default=RUNNING
    )
    do_pivot = new_status == RUNNING
    if active is not None:
        do_pivot = do_pivot & active

    # --- basis change: rank-1 product-form update in df; the in-place
    # writes touch only tensors made here ---
    r1 = r.reshape(1)
    w_rh, w_rl = _at(wh, r), _at(wl, r)
    safe_wrh = torch.where(do_pivot, w_rh, 1.0)
    safe_wrl = torch.where(do_pivot, w_rl, 0.0)
    xB_r = _at(state.xB, r)
    pos_r = xB_r > 0.0
    xrh = torch.where(pos_r, xB_r, 0.0)
    xrl = torch.where(pos_r, _at(state.xB_lo, r), 0.0)
    th, tl = df_div(xrh, xrl, safe_wrh, safe_wrl)
    beta_h, beta_l = df_div(
        _at(state.Binv, r), _at(state.Binv_lo, r), safe_wrh, safe_wrl
    )

    # Binv - outer(w, beta), keeping the first-order compensation terms.
    ph, pe = two_prod(wh[:, None], beta_h[None, :])
    pe = pe + (wh[:, None] * beta_l[None, :] + wl[:, None] * beta_h[None, :])
    Bh_new, Bl_new = df_sub(state.Binv, state.Binv_lo, ph, pe)
    Bh_new.index_copy_(0, r1, beta_h.reshape(1, M))
    Bl_new.index_copy_(0, r1, beta_l.reshape(1, M))

    xh_step, xl_step = df_mul(th, tl, wh, wl)
    xBh_new, xBl_new = df_sub(state.xB, state.xB_lo, xh_step, xl_step)
    xBh_new.index_copy_(0, r1, th.reshape(1))
    xBl_new.index_copy_(0, r1, tl.reshape(1))

    leaving = _at(state.basis, r).to(torch.int64).reshape(1)
    basis_new = state.basis.clone().index_copy_(0, r1, q1.to(torch.int32))
    in_basis_new = (
        state.in_basis.clone().index_fill_(0, leaving, False).index_fill_(0, q1, True)
    )

    # pi' = pi + d_q beta (incremental dual update, df).
    dh, de = df_mul(dqh, dql, beta_h, beta_l)
    pih_new, pil_new = df_add(state.pi, state.pi_lo, dh, de)

    # obj = c_B . x_B, compensated (phase 1's stop_at_zero reads obj).
    basis64 = basis_new.to(torch.int64)
    objh_new, objl_new = df_dot(
        ch.index_select(0, basis64), cl.index_select(0, basis64), xBh_new, xBl_new
    )

    # --- f32 scans: the next reduced costs and the Goldfarb gamma update ---
    if pricing == PRICE_STEEPEST:
        gamma_q_val = 1.0 + torch.matmul(wh, wh)
        v = torch.matmul(wh, state.Binv)  # work vector, OLD inverse (f32)
        P = torch.stack([pih_new, v, beta_h])
        d_next, gamma_new = fused_price_scan(P, A_scan, c_scan, state.gamma, gamma_q_val)
        gamma_new.index_copy_(
            0, leaving,
            torch.clamp_min(gamma_q_val / (safe_wrh * safe_wrh), 1.0).reshape(1),
        )
        gamma_new.index_fill_(0, q1, 1.0)
    else:
        gamma_new = state.gamma
        d_next = c_scan - torch.matmul(pih_new, A_scan)

    degen_new = torch.where(th <= degen_tol, state.degen_count + 1, 0).to(torch.int32)

    def select(new, old):
        return torch.where(do_pivot, new, old)

    if active is None:
        status, inner = new_status, state.inner + 1
    else:
        status = torch.where(active, new_status, state.status)
        inner = state.inner + active.to(torch.int32)
    return DfSimplexState(
        Binv=select(Bh_new, state.Binv),
        Binv_lo=select(Bl_new, state.Binv_lo),
        basis=select(basis_new, state.basis),
        xB=select(xBh_new, state.xB),
        xB_lo=select(xBl_new, state.xB_lo),
        pi=select(pih_new, state.pi),
        pi_lo=select(pil_new, state.pi_lo),
        obj=select(objh_new, state.obj),
        obj_lo=select(objl_new, state.obj_lo),
        in_basis=select(in_basis_new, state.in_basis),
        gamma=select(gamma_new, state.gamma),
        iteration=state.iteration + do_pivot.to(torch.int32),
        status=status,
        degen_count=select(degen_new, state.degen_count),
        inner=inner,
        price_start=select((q + 1) % N, state.price_start).to(torch.int32),
        d=select(d_next, state.d),
    )


def make_df_iteration(
    pricing: int, opt_tol, pivot_tol, degen_tol, noisy_scan: bool = False,
):
    """One df32 iteration ``(state, A_scan, Ah, Al, ch, cl, c_scan,
    candidate_mask) -> state``, as ``relp_tpu.simplex.df_kernels.
    make_df_iteration`` builds it.  The port's scans are true f32, so the
    JAX package's ``hi_scan`` polish mode has no counterpart."""

    def iteration(state, A_scan, Ah, Al, ch, cl, c_scan, candidate_mask):
        return _df_iteration(
            state, A_scan, Ah, Al, ch, cl, c_scan, candidate_mask, None,
            pricing=pricing, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, noisy=noisy_scan,
        )

    return iteration


def df_run_chunk(
    state: DfSimplexState,
    A_scan,
    Ah,
    Al,
    ch,
    cl,
    candidate_mask,
    *,
    pricing: int,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    degen_tol: float,
    stop_at_zero: bool = False,
    noisy_scan: bool = False,
    early_exit: Optional[bool] = None,
) -> DfSimplexState:
    """Run up to ``chunk`` df32 pivots.  ``early_exit`` stops at the first
    inactive iteration (default: on the CPU; the result is the same), a
    host read an iteration; without it the chunk has no host read."""
    if early_exit is None:
        early_exit = A_scan.device.type == "cpu"
    c_scan = ch
    state = state._replace(
        inner=torch.zeros((), dtype=torch.int32, device=ch.device),
        d=c_scan - torch.matmul(state.pi, A_scan),
    )
    for _ in range(chunk):
        active = state.status == RUNNING
        if stop_at_zero:
            active = active & (state.obj > 1e-9)
        if early_exit and not bool(active):
            break
        state = _df_iteration(
            state, A_scan, Ah, Al, ch, cl, c_scan, candidate_mask, active,
            pricing=pricing, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, noisy=noisy_scan,
        )
    return state


def _host64(pair) -> np.ndarray:
    return pair.hi.to(torch.float64).cpu().numpy() + pair.lo.to(torch.float64).cpu().numpy()


def df_refactorize(state: DfSimplexState, A: DfMatrix, b: DfVec, c: DfVec,
                   feas_tol: float):
    """Host f64 refactorization, split back into the df carry; returns
    (state, residual max|B X - I|).  Only the (m, m) basis matrix crosses
    to the host."""
    basis_t = state.basis.to(torch.int64)
    B = _host64(DfMatrix(A.hi.index_select(1, basis_t), A.lo.index_select(1, basis_t)))
    M = B.shape[0]
    try:
        X = np.linalg.inv(B)
    except np.linalg.LinAlgError:
        return state, float("inf")
    residual = float(np.max(np.abs(B @ X - np.eye(M))))
    basis = basis_t.cpu().numpy()
    b64 = _host64(b)
    c64 = _host64(c)
    xB = X @ b64
    xB = np.where(xB > -feas_tol, np.maximum(xB, 0.0), xB)
    cB = c64[basis]
    pi = cB @ X
    obj = float(cB @ xB)
    device = state.Binv.device
    Xh, Xl = df_from_f64(X, device)
    xh, xl = df_from_f64(xB, device)
    pih, pil = df_from_f64(pi, device)
    oh, ol = df_from_f64(np.float64(obj), device)
    return (
        state._replace(
            Binv=Xh, Binv_lo=Xl, xB=xh, xB_lo=xl, pi=pih, pi_lo=pil,
            obj=oh, obj_lo=ol,
        ),
        residual,
    )


def df_make_state(A64, b64, c64, basis, device=None) -> DfSimplexState:
    """Initial df32 state for an identity starting basis; ``A64/b64/c64``
    are host f64 arrays, the carry is split hi/lo."""
    A64 = np.asarray(A64, np.float64)
    b64 = np.asarray(b64, np.float64)
    c64 = np.asarray(c64, np.float64)
    M, N = A64.shape
    in_basis = np.zeros(N, dtype=bool)
    in_basis[basis] = True
    cB = c64[basis]
    d0 = (c64 - cB @ A64).astype(np.float32)
    xh, xl = df_from_f64(b64, device)
    pih, pil = df_from_f64(cB, device)
    oh, ol = df_from_f64(np.float64(cB @ b64), device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return DfSimplexState(
        Binv=torch.eye(M, dtype=torch.float32, device=device),
        Binv_lo=torch.zeros((M, M), dtype=torch.float32, device=device),
        basis=torch.as_tensor(np.asarray(basis, dtype=np.int32), device=device),
        xB=xh,
        xB_lo=xl,
        pi=pih,
        pi_lo=pil,
        obj=oh,
        obj_lo=ol,
        in_basis=torch.as_tensor(in_basis, device=device),
        gamma=torch.ones(N, dtype=torch.float32, device=device),
        iteration=zero,
        status=torch.tensor(RUNNING, dtype=torch.int32, device=device),
        degen_count=zero,
        inner=zero,
        price_start=zero,
        d=torch.as_tensor(d0, device=device),
    )


def df_forced_pivot(state: DfSimplexState, A: DfMatrix, c: DfVec, q: int, r: int):
    """Unconditional df pivot (zero-level artificial drive-out); q and r
    are host ints."""
    a_qh, a_ql = A.hi[:, q], A.lo[:, q]
    wh, wl = df_matvec(state.Binv, state.Binv_lo, a_qh, a_ql)
    w_rh, w_rl = wh[r], wl[r]
    th, tl = df_div(state.xB[r], state.xB_lo[r], w_rh, w_rl)
    beta_h, beta_l = df_div(state.Binv[r], state.Binv_lo[r], w_rh, w_rl)
    ph, pe = two_prod(wh[:, None], beta_h[None, :])
    pe = pe + (wh[:, None] * beta_l[None, :] + wl[:, None] * beta_h[None, :])
    Bh_new, Bl_new = df_sub(state.Binv, state.Binv_lo, ph, pe)
    Bh_new[r] = beta_h  # fresh tensors
    Bl_new[r] = beta_l
    xh_step, xl_step = df_mul(th, tl, wh, wl)
    xBh, xBl = df_sub(state.xB, state.xB_lo, xh_step, xl_step)
    xBh[r] = th
    xBl[r] = tl
    leaving = state.basis[r].to(torch.int64).reshape(1)
    basis_new = state.basis.clone()
    basis_new[r] = q
    in_basis_new = state.in_basis.clone().index_fill_(0, leaving, False)
    in_basis_new[q] = True
    basis64 = basis_new.to(torch.int64)
    cBh, cBl = c.hi.index_select(0, basis64), c.lo.index_select(0, basis64)
    pih, pil = df_vecmat(cBh, cBl, Bh_new, Bl_new)
    oh, ol = df_dot(cBh, cBl, xBh, xBl)
    return state._replace(
        Binv=Bh_new,
        Binv_lo=Bl_new,
        basis=basis_new,
        xB=xBh,
        xB_lo=xBl,
        pi=pih,
        pi_lo=pil,
        obj=oh,
        obj_lo=ol,
        in_basis=in_basis_new,
        iteration=state.iteration + 1,
    )


def df_tableau_row(state: DfSimplexState, A: DfMatrix, r: int) -> torch.Tensor:
    """Row r of the tableau, compensated: (B^-1)[r] @ A (the hi part)."""
    rh, _rl = df_vecmat(state.Binv[r], state.Binv_lo[r], A.hi, A.lo)
    return rh
