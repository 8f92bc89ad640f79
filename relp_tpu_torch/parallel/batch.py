"""Scenario batches: the port of ``relp_tpu.parallel.batch``.

Every state field gains a leading batch dimension B and all LPs advance in
lockstep with a per-LP ``active`` mask; a frozen LP keeps its state.  The JAX
package writes this as ``jax.vmap`` of the single-LP iteration inside a
``lax.while_loop``; here the batch dimension is written out: selections are
``argmax``/``argmin`` over dim 1, single entries are read with ``gather`` /
``take_along_dim`` and written with ``torch.where`` against an index, so no
tensor is updated in place.  A chunk is a fixed number of iterations with no
host read on CUDA, as in ``relp_tpu_torch.simplex.kernels.run_chunk``; on the
CPU the loop stops once no LP is active.  At B=1 the batched iteration is the
single-LP ``_iteration``.

``megakernel_run_chunk`` runs a chunk through the hand-written batched-pivot
kernels of ``relp_tpu_torch.ops.batch_pivot`` (one CUDA block per LP).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from relp_tpu_torch.simplex import kernels
from relp_tpu_torch.simplex.kernels import (
    _NOISY_F32_EPS,
    _INT32_MAX,
    _status,
    PRICE_BLAND,
    PRICE_DANTZIG,
    PRICE_FIRST_MEMORY,
    PRICE_STEEPEST,
)
from relp_tpu_torch.simplex.state import (
    INFEASIBLE,
    OPTIMAL,
    RUNNING,
    SINGULAR,
    UNBOUNDED,
    SimplexState,
)


def make_batch_state(states: Sequence[SimplexState]) -> SimplexState:
    """Stack per-LP states into one batched state."""
    return SimplexState(*(torch.stack(fields) for fields in zip(*states)))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for a (B, K) tensor and a (B,) index."""
    return torch.take_along_dim(x, idx.reshape(-1, 1), dim=1).reshape(-1)


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b], :] for a (B, K, L) tensor and a (B,) index."""
    return torch.take_along_dim(x, idx.reshape(-1, 1, 1), dim=1).squeeze(1)


def _col(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, :, idx[b]] for a (B, K, L) tensor and a (B,) index."""
    return torch.take_along_dim(x, idx.reshape(-1, 1, 1), dim=2).squeeze(2)


def _matvec(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X[b] @ v[b] for (B, K, L) and (B, L)."""
    return torch.matmul(X, v.unsqueeze(-1)).squeeze(-1)


def _vecmat(v: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """v[b] @ X[b] for (B, K) and (B, K, L)."""
    return torch.matmul(v.unsqueeze(1), X).squeeze(1)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u[b] . v[b] for two (B, K) tensors."""
    return torch.matmul(u.unsqueeze(1), v.unsqueeze(-1)).reshape(-1)


def _ids(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device).unsqueeze(0)


def _select(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """new where the per-LP (B,) mask holds, else old."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _select_entering(d, gamma, eligible, pricing: int, start):
    """Per-LP entering column; returns (q, any_eligible), q int64 (B,)."""
    N = d.shape[1]
    any_eligible = eligible.any(dim=1)
    if pricing == PRICE_DANTZIG:
        q = torch.argmax(torch.where(eligible, -d, float("-inf")), dim=1)
    elif pricing == PRICE_STEEPEST:
        q = torch.argmax(torch.where(eligible, d * d / gamma, float("-inf")), dim=1)
    elif pricing == PRICE_FIRST_MEMORY:
        rotated = (_ids(N, d) - start.unsqueeze(1)) % N
        q = torch.argmin(torch.where(eligible, rotated, N), dim=1)
    else:  # Bland / first-profitable: smallest eligible index
        q = torch.clamp_max(torch.where(eligible, _ids(N, d), N).amin(dim=1), N - 1)
    return q, any_eligible


def _select_leaving(xB, w, basis, pricing: int, pivot_tol: float):
    """Per-LP Harris two-pass ratio test (Bland: lowest leaving basis index
    among near ties).  Returns (r, any_positive), r int64 (B,)."""
    pos = w > pivot_tol
    safe_w = torch.where(pos, w, 1.0)
    xB_eff = torch.clamp_min(xB, 0.0)
    ratio = torch.where(pos, xB_eff / safe_w, float("inf"))
    any_positive = pos.any(dim=1)
    if pricing == PRICE_BLAND:
        tmin = ratio.amin(dim=1, keepdim=True)
        near = pos & (ratio <= tmin + 1e-12 * (1.0 + tmin.abs()))
        r = torch.argmin(torch.where(near, basis, _INT32_MAX), dim=1)
    else:
        delta = 1e-7 * (1.0 + xB_eff)
        relaxed = torch.where(pos, (xB_eff + delta) / safe_w, float("inf"))
        theta = relaxed.amin(dim=1, keepdim=True)
        ok = pos & (ratio <= theta)
        r = torch.argmax(torch.where(ok, w, float("-inf")), dim=1)
    return r, any_positive


def _batched_iteration(
    s: SimplexState, A_scan, A_full, c, c_scan, candidate_mask,
    active: torch.Tensor, *, pricing: int, opt_tol: float, pivot_tol: float,
    degen_tol: float, noisy_scan: bool,
) -> SimplexState:
    """One primal iteration of every LP: ``_iteration`` of
    relp_tpu_torch.simplex.kernels with a leading batch dimension."""
    B, M, N = A_scan.shape
    scan_dtype = A_scan.dtype
    low_precision_scan = scan_dtype != A_full.dtype
    noisy = noisy_scan and not low_precision_scan and scan_dtype == torch.float32
    guarded = low_precision_scan or noisy

    # --- pricing from the carried reduced costs ---
    d = s.d
    if guarded:
        noise = (
            _NOISY_F32_EPS if noisy else float(torch.finfo(scan_dtype).eps) * 8.0
        )
        threshold = opt_tol + noise * (1.0 + s.pi.abs().amax(dim=1)).to(scan_dtype)
        if noisy:
            threshold = torch.where(s.inner == 0, opt_tol, threshold)
        threshold = threshold.unsqueeze(1)
    else:
        threshold = opt_tol
    eligible = candidate_mask & ~s.in_basis & (d < -threshold)
    gamma = s.gamma.to(scan_dtype)
    q, any_eligible = _select_entering(d, gamma, eligible, pricing, s.price_start)

    # --- FTRAN at working precision ---
    a_q = _col(A_full, q)
    w = _matvec(s.Binv, a_q)
    d_q_full = _take(c, q) - _dot(s.pi, a_q)
    if guarded:
        any_eligible = any_eligible & (d_q_full < -opt_tol)

    # --- ratio test ---
    r, any_positive = _select_leaving(s.xB, w, s.basis, pricing, pivot_tol)
    new_status = _status(
        (~any_eligible, OPTIMAL), (~any_positive, UNBOUNDED), default=RUNNING
    )
    do_pivot = (new_status == RUNNING) & active

    # --- basis change (product-form update) ---
    row_r = _ids(M, w) == r.unsqueeze(1)  # (B, M)
    col_q = _ids(N, d) == q.unsqueeze(1)  # (B, N)
    w_r = _take(w, r)
    safe_w_r = torch.where(do_pivot, w_r, 1.0)
    t = torch.clamp_min(_take(s.xB, r), 0.0) / safe_w_r
    Binv_r = _row(s.Binv, r) / safe_w_r.unsqueeze(1)
    Binv_new = torch.where(
        row_r.unsqueeze(2), Binv_r.unsqueeze(1),
        s.Binv - w.unsqueeze(2) * Binv_r.unsqueeze(1),
    )
    xB_new = torch.where(row_r, t.unsqueeze(1), s.xB - t.unsqueeze(1) * w)

    leaving = _take(s.basis, r).to(torch.int64)
    col_leaving = _ids(N, d) == leaving.unsqueeze(1)
    basis_new = torch.where(row_r, q.to(torch.int32).unsqueeze(1), s.basis)
    in_basis_new = torch.where(col_q, True, torch.where(col_leaving, False, s.in_basis))

    # Incremental dual update; the objective is recomputed as cB . xB.
    pi_new = s.pi + d_q_full.unsqueeze(1) * Binv_r
    obj_new = _dot(torch.take_along_dim(c, basis_new.to(torch.int64), dim=1), xB_new)

    # --- next reduced costs and, for steepest edge, the Goldfarb weights:
    # one stacked (3, M) x (M, N) product per LP ---
    if pricing == PRICE_STEEPEST:
        gamma_q = (1.0 + _dot(w, w)).to(scan_dtype).unsqueeze(1)
        v = _vecmat(w, s.Binv).to(scan_dtype)  # work vector, OLD inverse
        P = torch.stack([pi_new.to(scan_dtype), v, Binv_r.to(scan_dtype)], dim=1)
        S = torch.matmul(P, A_scan)
        d_next = c_scan - S[:, 0]
        inner, abar = S[:, 1], S[:, 2]
        g = gamma - 2.0 * abar * inner + (abar * abar) * gamma_q
        gamma_new = torch.maximum(g, 1.0 + abar * abar)
        g_leaving = torch.clamp_min(
            gamma_q / (safe_w_r * safe_w_r).to(scan_dtype).unsqueeze(1), 1.0
        )
        gamma_new = torch.where(col_leaving, g_leaving, gamma_new)
        gamma_new = torch.where(col_q, 1.0, gamma_new).to(s.gamma.dtype)
    else:
        gamma_new = s.gamma
        d_next = c_scan - _vecmat(pi_new.to(scan_dtype), A_scan)

    degen_new = torch.where(t <= degen_tol, s.degen_count + 1, 0).to(torch.int32)

    select = functools.partial(_select, do_pivot)
    return SimplexState(
        Binv=select(Binv_new, s.Binv),
        basis=select(basis_new, s.basis),
        xB=select(xB_new, s.xB),
        pi=select(pi_new, s.pi),
        obj=select(obj_new, s.obj),
        in_basis=select(in_basis_new, s.in_basis),
        gamma=select(gamma_new, s.gamma),
        iteration=s.iteration + do_pivot.to(torch.int32),
        status=torch.where(active, new_status, s.status),
        degen_count=select(degen_new, s.degen_count),
        inner=s.inner + active.to(torch.int32),
        price_start=select(((q + 1) % N).to(torch.int32), s.price_start),
        d=select(d_next, s.d),
    )


def _batched_dual_iteration(
    s: SimplexState, A_scan, A_full, c, candidate_mask, active, *,
    pivot_tol: float, feas_tol: float, noisy_scan: bool,
) -> SimplexState:
    """One dual iteration of every LP: ``_dual_iteration`` of
    relp_tpu_torch.simplex.kernels with a leading batch dimension."""
    B, M, N = A_scan.shape
    scan_dtype = A_scan.dtype

    r = torch.argmin(s.xB, dim=1)
    xB_r = _take(s.xB, r)
    feasible = xB_r >= -feas_tol

    # --- pivot row of the tableau: alpha = Binv[r] @ A ---
    rho = _row(s.Binv, r)
    alpha = _vecmat(rho.to(scan_dtype), A_scan)
    d = s.d
    if noisy_scan and scan_dtype == torch.float32:
        alpha_floor = (
            pivot_tol + _NOISY_F32_EPS * (1.0 + rho.abs().amax(dim=1))
        ).to(scan_dtype).unsqueeze(1)
    else:
        alpha_floor = pivot_tol
    eligible = candidate_mask & ~s.in_basis & (alpha < -alpha_floor)
    any_eligible = eligible.any(dim=1)

    d_eff = torch.clamp_min(d, 0.0)
    ratio = torch.where(eligible, d_eff / (-alpha), float("inf"))
    tmin = ratio.amin(dim=1, keepdim=True)
    near = eligible & (ratio <= tmin + 1e-7 * (1.0 + tmin.abs()))
    q = torch.argmax(torch.where(near, -alpha, float("-inf")), dim=1)

    # --- FTRAN at working precision ---
    a_q = _col(A_full, q)
    w = _matvec(s.Binv, a_q)
    w_r = _take(w, r)
    pivot_ok = w_r < -pivot_tol

    new_status = _status(
        (feasible, OPTIMAL),
        (~any_eligible, INFEASIBLE),
        (~pivot_ok, SINGULAR),
        default=RUNNING,
    )
    do_pivot = (new_status == RUNNING) & active

    # --- basis change ---
    row_r = _ids(M, w) == r.unsqueeze(1)
    col_q = _ids(N, d) == q.unsqueeze(1)
    safe_w_r = torch.where(do_pivot, w_r, 1.0)
    t = xB_r / safe_w_r  # >= 0: negative over negative
    Binv_r = rho / safe_w_r.unsqueeze(1)
    Binv_new = torch.where(
        row_r.unsqueeze(2), Binv_r.unsqueeze(1),
        s.Binv - w.unsqueeze(2) * Binv_r.unsqueeze(1),
    )
    xB_new = torch.where(row_r, t.unsqueeze(1), s.xB - t.unsqueeze(1) * w)

    leaving = _take(s.basis, r).to(torch.int64)
    col_leaving = _ids(N, d) == leaving.unsqueeze(1)
    basis_new = torch.where(row_r, q.to(torch.int32).unsqueeze(1), s.basis)
    in_basis_new = torch.where(col_q, True, torch.where(col_leaving, False, s.in_basis))

    # Dual price update: theta = d_q / (-alpha_q) >= 0.
    d_q_full = _take(c, q) - _dot(s.pi, a_q)
    theta = d_q_full / (-safe_w_r)
    pi_new = s.pi - theta.unsqueeze(1) * rho
    theta_scan = theta.to(scan_dtype).unsqueeze(1)
    d_next = d + theta_scan * alpha
    d_next = torch.where(col_q, 0.0, d_next)
    d_next = torch.where(col_leaving, theta_scan, d_next).to(d.dtype)
    obj_new = _dot(torch.take_along_dim(c, basis_new.to(torch.int64), dim=1), xB_new)

    select = functools.partial(_select, do_pivot)
    return s._replace(
        Binv=select(Binv_new, s.Binv),
        basis=select(basis_new, s.basis),
        xB=select(xB_new, s.xB),
        pi=select(pi_new, s.pi),
        obj=select(obj_new, s.obj),
        in_basis=select(in_basis_new, s.in_basis),
        iteration=s.iteration + do_pivot.to(torch.int32),
        status=torch.where(active, new_status, s.status),
        inner=s.inner + active.to(torch.int32),
        d=select(d_next, s.d),
    )


# --- batched refactorization helpers: the single-LP kernels under
# torch.vmap, as the JAX batch driver vmaps them (batch_driver.py:62-86) ---


def _v_newton(Binv, A, b, c, basis, *, steps: int):
    """Newton-Schulz refresh of every carried inverse: (Binv, xB, pi, obj,
    residual), each with a leading batch dimension."""
    fn = functools.partial(kernels.newton_refresh, steps=steps)
    return torch.vmap(fn)(Binv, A, b, c, basis)


def _v_refactor(A, b, c, basis, *, newton_steps: int):
    """From-scratch inverses of every basis (f32 ``inv_ex`` + Newton-Schulz;
    a singular basis gives a non-finite residual)."""
    fn = functools.partial(kernels.refactorize, newton_steps=newton_steps)
    return torch.vmap(fn)(A, b, c, basis)


def _v_gamma(Binv, A_scan, in_basis):
    """Exact steepest-edge weights 1 + ||Binv a_j||^2 of every LP."""
    return torch.vmap(kernels.recompute_gamma)(Binv, A_scan, in_basis)


def _refresh_d(s: SimplexState, A_scan, c_scan) -> SimplexState:
    """Reduced costs from the current duals, d = c - pi A, per LP."""
    return s._replace(d=c_scan - _vecmat(s.pi.to(A_scan.dtype), A_scan))


def batched_run_chunk(
    batch_state: SimplexState,
    A_scan,  # (B, M, N), possibly lower precision
    A_full,  # (B, M, N)
    c,  # (B, N)
    candidate_mask,  # (B, N)
    *,
    pricing: int,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    degen_tol: float,
    stop_at_zero: bool = False,
    refactor_period: int = 0,
    b: Optional[torch.Tensor] = None,  # (B, M), needed when refactor_period > 0
    newton_steps: int = 1,
    feas_tol: float = 1e-9,
    noisy_scan: bool = False,
) -> SimplexState:
    """Advance every LP in the batch by up to ``chunk`` pivots.

    ``stop_at_zero`` freezes an LP once its objective reaches zero (per-LP
    phase-1 termination).  ``refactor_period > 0`` refreshes every LP's
    inverse on the device every ``refactor_period`` loop steps (batched
    Newton-Schulz with ``max(2, newton_steps + 1)`` steps, the xB clamp, and
    for steepest edge fresh weights), as the JAX package does.
    """
    c_scan = c.to(A_scan.dtype)
    s = _refresh_d(
        batch_state._replace(inner=torch.zeros_like(batch_state.inner)), A_scan, c_scan
    )
    on_cpu = A_scan.device.type == "cpu"

    def active_mask(s):
        active = s.status == RUNNING
        if stop_at_zero:
            active = active & (s.obj > 1e-9)
        return active

    if refactor_period > 0:
        if b is None:
            raise ValueError("the in-chunk refactorization cadence needs b")

        def refresh(s):
            Binv, xB, pi, obj, _residual = _v_newton(
                s.Binv, A_full, b, c, s.basis, steps=max(2, newton_steps + 1)
            )
            xB = torch.where(xB > -feas_tol, torch.clamp_min(xB, 0.0), xB)
            s = s._replace(Binv=Binv, xB=xB, pi=pi, obj=obj)
            if pricing == PRICE_STEEPEST:
                s = s._replace(gamma=_v_gamma(Binv, A_scan, s.in_basis))
            return _refresh_d(s, A_scan, c_scan)

    for k in range(chunk):
        active = active_mask(s)
        if on_cpu and not bool(active.any()):
            break
        if refactor_period > 0 and k > 0 and k % refactor_period == 0:
            fresh = refresh(s)
            if on_cpu:
                s = fresh
            else:
                # The JAX loop has ended once no LP is active; without a host
                # read the refresh is kept only while one is.
                any_active = active.any()
                s = SimplexState(*(
                    torch.where(any_active, n, o) for n, o in zip(fresh, s)
                ))
            active = active_mask(s)
        s = _batched_iteration(
            s, A_scan, A_full, c, c_scan, candidate_mask, active,
            pricing=pricing, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, noisy_scan=noisy_scan,
        )
    return s


def batched_dual_run_chunk(
    batch_state: SimplexState,
    A_scan,  # (B, M, N)
    A_full,  # (B, M, N)
    c,  # (B, N)
    candidate_mask,  # (B, N)
    *,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    feas_tol: float,
    noisy_scan: bool = False,
) -> SimplexState:
    """Advance every LP by up to ``chunk`` dual pivots (lockstep, per-LP
    freezing): the batched warm restart of a perturbed-rhs family from one
    dual-feasible basis.  Terminal statuses: OPTIMAL (primal feasibility
    restored) or INFEASIBLE (dual ray; solve_batch sends those to the
    single-LP fallback for the exact Farkas certificate)."""
    c_scan = c.to(A_scan.dtype)
    s = _refresh_d(
        batch_state._replace(inner=torch.zeros_like(batch_state.inner)), A_scan, c_scan
    )
    on_cpu = A_scan.device.type == "cpu"
    for _ in range(chunk):
        active = s.status == RUNNING
        if on_cpu and not bool(active.any()):
            break
        s = _batched_dual_iteration(
            s, A_scan, A_full, c, candidate_mask, active,
            pivot_tol=pivot_tol, feas_tol=feas_tol, noisy_scan=noisy_scan,
        )
    return s


def megakernel_run_chunk(
    batch_state: SimplexState,
    A,  # (B, M, N) f32 tableau (same-precision scans)
    c,  # (B, N)
    candidate_mask,  # (B, N)
    *,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    degen_tol: float,
    stop_at_zero: bool = False,
) -> SimplexState:
    """Advance the batch by up to ``chunk`` pivots through the batched-pivot
    kernel (``relp_tpu_torch.ops.batch_pivot``): one CUDA block per LP runs
    the whole chunk, instead of the batched small-op chain.  CPU tensors
    take the kernels' plain version.

    Same contract as :func:`batched_run_chunk` in its production
    configuration (f32, same-precision scans, steepest edge).  As in the JAX
    package, ``obj`` is recomputed as cB . xB afterwards, ``inner`` is set to
    ``chunk`` and the carried ``d`` is left stale (every chunk entry
    refreshes it).  The port's f32 products are true f32
    (``noisy_f32_matmul()`` is False), so the kernels run with the JAX
    kernels' ``noise_eps`` = 0 semantics.
    """
    from relp_tpu_torch.ops import batch_pivot

    variant = _megakernel_variant(A.shape)
    if variant is None:
        raise ValueError(f"no batched-pivot kernel takes the shape {tuple(A.shape)}")
    impl = (
        batch_pivot.batched_pivot_chunk
        if variant == "resident"
        else batch_pivot.batched_pivot_chunk_blocked
    )
    Binv, xB, pi, basis, in_basis, gamma, status, iteration, degen = impl(
        A, c, candidate_mask,
        batch_state.Binv, batch_state.xB, batch_state.pi, batch_state.basis,
        batch_state.in_basis, batch_state.gamma, batch_state.status,
        batch_state.iteration, batch_state.degen_count,
        chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
        degen_tol=degen_tol, stop_at_zero=stop_at_zero,
    )
    cB = torch.take_along_dim(c, basis.to(torch.int64), dim=1)
    obj = (cB * xB).sum(dim=1)
    return batch_state._replace(
        Binv=Binv,
        xB=xB,
        pi=pi,
        basis=basis,
        in_basis=in_basis,
        gamma=gamma,
        status=status,
        iteration=iteration,
        degen_count=degen,
        obj=obj.to(batch_state.obj.dtype),
        inner=torch.full_like(batch_state.inner, chunk),
    )


def _megakernel_variant(shape):
    """Pick the batched-pivot kernel for a (B, M, N) batch shape, by what
    one CUDA block of the H100 can hold in shared memory (232,448 bytes
    opt-in; ``relp_tpu_torch.ops.batch_pivot.SMEM_LIMIT``):

    * ``"resident"`` when one LP's (M, M) f32 inverse, its vector state and
      the work scratch fit a 256-thread block ((M^2 + 8M + 3N + 136 +
      scratch) 4 + 2N bytes, ``smem_bytes``; the scratch is at most about
      3 N (256 / (N / 4)) words): M <= 128 at the families' widths (an
      M=256 inverse alone is 256 KB);
    * ``"blocked"`` when the vector state, the scratch and the 5-tile ring
      of streamed inverse rows (at most 5 x 16 KB) fit: the
      inverse stays in device memory, updated in place, and the rows that
      fit beside the rest (``blocked_rows``: 45 of 512 at 512 x 1408) stay
      in shared memory for the chunk;
    * ``None`` otherwise.

    The JAX package sized these by the TPU's VMEM (6 MB / 12 MB budgets,
    batch.py:112-137) and returned the blocked kernel's column block with
    the variant; here the blocked kernel takes no block size, and a
    512 x 1408 family, "resident" on the TPU, is "blocked" on the H100.
    """
    from relp_tpu_torch.ops.batch_pivot import SMEM_LIMIT, smem_bytes

    _, M, N = shape
    if smem_bytes(M, N, resident=True) <= SMEM_LIMIT:
        return "resident"
    if smem_bytes(M, N, resident=False) <= SMEM_LIMIT:
        return "blocked"
    return None


def megakernel_applicable(
    A, cfg_dtype: str, scan_dtype: str, pricing: int, mesh=None
) -> bool:
    """Shape/config gate for the batched-pivot kernels (the JAX package's
    gate, with the Hopper variants)."""
    B, M, N = A.shape
    return (
        mesh is None
        and pricing == PRICE_STEEPEST
        and cfg_dtype == "float32"
        and scan_dtype in ("float32", "same")
        and M % 8 == 0
        and N % 128 == 0
        and _megakernel_variant(A.shape) is not None
    )
