"""Simplex kernels: the port of ``relp_tpu.simplex.kernels``.

The same iteration as the JAX package (pricing from the carried reduced
costs, FTRAN as an (M,M) matvec, Harris two-pass ratio test, rank-1
product-form update of Binv/xB/pi, and one stacked (3,M)x(M,N) scan for the
next reduced costs and the Goldfarb steepest-edge weights), written with
torch tensors.  The stacked scan goes through the hand-written CUDA kernel
``relp_tpu_torch.ops.fused_price_scan``; everything else is M-sized or
(M,M) work in torch ops.

Differences from the JAX code, and why:

* A chunk is a fixed number of iterations with a device-side ``active``
  mask instead of a ``lax.while_loop``: reading ``status`` on the host each
  pivot would synchronise every pivot.  Once inactive, an iteration is a
  no-op (the JAX iteration is already a masked no-op after termination).
  On the CPU, where a read costs nothing, the loop stops at the first
  inactive iteration; the result is the same.  On CUDA the whole loop
  makes no host read and no host-to-device copy, so that
  ``relp_tpu_torch.simplex.graphs`` can capture it as one CUDA graph, the
  counterpart of the JAX package's jit-compiled ``while_loop``.
* Index tensors are int64 (``basis`` stays int32 in the state); single
  elements are read with ``index_select`` and written with ``index_copy_`` /
  ``index_fill_`` on tensors this module has just created, never on a tensor
  that a later ``torch.where`` still needs as the old value.
* Matmuls are true f32 or f64 (TF32 is off, see config.torch_device), so
  ``noisy_f32_matmul()`` is False and the noise guards stay dormant unless
  the scan dtype is lower than the working dtype.
* Column sharding (``shard``, a ``relp_tpu_torch.parallel.sharded.
  ColumnShard``) is explicit: the JAX package lets GSPMD partition the same
  code.  With a shard, A, c, the mask and the N-sized state hold this
  rank's columns, indices stay global, and the entering choice, the
  entering column and B at refactorization are combined across ranks.
  Without one, ``LocalColumns`` gives the same interface with no
  collective, so the kernels have one code path.
"""

from __future__ import annotations

from typing import Optional

import torch

from relp_tpu_torch.ops import fused_price_scan
from relp_tpu_torch.simplex.state import (
    INFEASIBLE,
    OPTIMAL,
    RUNNING,
    SINGULAR,
    UNBOUNDED,
    SimplexState,
)

# Pricing rule codes; equal to relp_tpu.simplex.kernels'.
PRICE_DANTZIG = 0
PRICE_STEEPEST = 1
PRICE_BLAND = 2  # first-profitable entering + lowest-index leaving
PRICE_FIRST = 3  # first profitable
PRICE_FIRST_MEMORY = 4  # round-robin resume

# Noise bound of a single-pass-bf16 f32 matmul, for the noisy-scan guard.
_NOISY_F32_EPS = 4e-3
_INT32_MAX = 2**31 - 1


def noisy_f32_matmul() -> bool:
    """False: CUDA (TF32 off) and CPU f32 matmuls are true f32."""
    return False


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without a host read."""
    return x.index_select(0, i.reshape(1)).reshape(x.shape[1:])


def _status(*pairs, default: int) -> torch.Tensor:
    """Nested where over (condition, code) pairs, first match wins."""
    out: Optional[torch.Tensor] = None
    for cond, code in reversed(pairs):
        other = default if out is None else out
        out = torch.where(cond, code, other)
    return out.to(torch.int32)


class LocalColumns:
    """Every column of the LP (or of each LP of a batch) on this device: the
    interface of ``relp_tpu_torch.parallel.sharded.ColumnShard`` with no
    collective, so that one code path serves both.  Indices are the
    columns' own."""

    def __init__(self, N: int, device):
        self.N = N
        self.device = device

    @property
    def ids(self) -> torch.Tensor:
        return torch.arange(self.N, device=self.device)

    def take(self, x):
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def best(self, key, loc, any_local):
        """(index, any eligible) of the first maximum ``loc`` of ``key``."""
        return loc, any_local

    def fetch(self, A, c, q, basis):
        """(A[:, q], c[q], c[basis]); per LP with a leading batch dimension."""
        if A.dim() == 2:
            a_q = A.index_select(1, q.reshape(1)).reshape(A.shape[0])
            return a_q, _at(c, q), c.index_select(0, basis.to(torch.int64))
        a_q = torch.take_along_dim(A, q.reshape(-1, 1, 1), dim=2).squeeze(2)
        c_q = torch.take_along_dim(c, q.reshape(-1, 1), dim=1).reshape(-1)
        return a_q, c_q, torch.take_along_dim(c, basis.to(torch.int64), dim=1)

    def basis_columns(self, A, c, basis):
        """(B, c_B) = (A[:, basis], c[basis]); per LP with a leading batch
        dimension."""
        basis64 = basis.to(torch.int64)
        if A.dim() == 2:
            return A.index_select(1, basis64), c.index_select(0, basis64)
        return (torch.take_along_dim(A, basis64.unsqueeze(1), dim=2),
                torch.take_along_dim(c, basis64, dim=1))

    def put(self, x: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
        """``x`` (a tensor the caller owns, written in place) with ``value``
        at column ``idx`` (one index)."""
        idx = idx.reshape(1).to(torch.int64)
        if isinstance(value, torch.Tensor):
            return x.index_copy_(0, idx, value.reshape(1).to(x.dtype))
        return x.index_fill_(0, idx, value)


def columns(shard, N: int, device):
    """The columns' interface: ``shard`` (a ``ColumnShard``, N then its
    global width) or, with none, the ``LocalColumns`` of N columns."""
    return LocalColumns(N, device) if shard is None else shard


def _select_entering(d, gamma, eligible, pricing: int, N: int, start=None,
                     shard=None):
    """Entering-column choice over the last dimension (per LP with a
    leading batch dimension); returns (q, any_eligible), q int64.  Each
    rule is a key whose first maximum wins: -d (Dantzig), d^2/gamma
    (steepest edge), else the negated distance past ``start`` (round-robin
    resume) or the negated index (the smallest eligible index).  With a
    ``shard`` the inputs are this rank's block, N is the global width, q is
    global, and ``shard.best`` takes the highest key over the ranks, the
    lowest global index on a tie."""
    cols = columns(shard, N, d.device)
    rotated = pricing == PRICE_FIRST_MEMORY and start is not None
    if pricing == PRICE_DANTZIG:
        key = torch.where(eligible, -d, float("-inf"))
    elif pricing == PRICE_STEEPEST:
        key = torch.where(eligible, d * d / gamma, float("-inf"))
    elif rotated:
        key = -torch.where(eligible, (cols.ids - start.unsqueeze(-1)) % N, N)
    else:
        key = -torch.where(eligible, cols.ids, N)
    q, any_eligible = cols.best(key, torch.argmax(key, dim=-1), eligible.any(dim=-1))
    if pricing not in (PRICE_DANTZIG, PRICE_STEEPEST) and not rotated:
        # min(eligible index, N) clamped: N - 1 when nothing is eligible.
        q = torch.where(any_eligible, q, N - 1)
    return q, any_eligible


def _select_leaving(xB, w, basis, pricing: int, pivot_tol: float):
    """Harris two-pass ratio test with a relative relaxation; Bland mode
    breaks near-ties by the smallest leaving basis index.  Returns
    (r, any_positive), r int64."""
    pos = w > pivot_tol
    safe_w = torch.where(pos, w, 1.0)
    # Tolerance-negative basic values count as zero.
    xB_eff = torch.clamp_min(xB, 0.0)
    ratio = torch.where(pos, xB_eff / safe_w, float("inf"))
    any_positive = pos.any()
    if pricing == PRICE_BLAND:
        tmin = ratio.min()
        near = pos & (ratio <= tmin + 1e-12 * (1.0 + tmin.abs()))
        r = torch.argmin(torch.where(near, basis, _INT32_MAX))
    else:
        delta = 1e-7 * (1.0 + xB_eff)
        relaxed = torch.where(pos, (xB_eff + delta) / safe_w, float("inf"))
        theta = relaxed.min()
        ok = pos & (ratio <= theta)
        r = torch.argmax(torch.where(ok, w, float("-inf")))
    return r, any_positive


def _iteration(
    state: SimplexState, A_scan, A_full, c, c_scan, candidate_mask,
    active: Optional[torch.Tensor], *, pricing: int, opt_tol: float,
    pivot_tol: float, degen_tol: float, noisy_scan: bool, shard=None,
) -> SimplexState:
    M = A_scan.shape[0]
    cols = columns(shard, A_scan.shape[1], A_scan.device)
    N = cols.N
    scan_dtype = A_scan.dtype
    low_precision_scan = scan_dtype != A_full.dtype
    noisy = noisy_scan and not low_precision_scan and scan_dtype == torch.float32
    guarded = low_precision_scan or noisy

    # --- pricing from the carried reduced costs ---
    d = state.d
    if guarded:
        # Low-precision reduced costs carry error ~eps |pi| |a|: scale the
        # eligibility floor by |pi|.
        noise = (
            _NOISY_F32_EPS if noisy else float(torch.finfo(scan_dtype).eps) * 8.0
        )
        threshold = opt_tol + noise * (1.0 + state.pi.abs().max()).to(scan_dtype)
        if noisy:
            threshold = torch.where(
                state.inner == 0,
                torch.full((), opt_tol, dtype=scan_dtype, device=d.device),
                threshold,
            )
    else:
        threshold = opt_tol
    eligible = candidate_mask & ~state.in_basis & (d < -threshold)
    gamma = state.gamma.to(scan_dtype)
    q, any_eligible = _select_entering(
        d, gamma, eligible, pricing, N, start=state.price_start, shard=shard
    )

    # --- FTRAN at working precision (c_B too, for the objective below) ---
    a_q, c_q, cB = cols.fetch(A_full, c, q, state.basis)
    w = torch.matmul(state.Binv, a_q)
    d_q_full = c_q - torch.matmul(state.pi, a_q)
    if guarded:
        # Scan noise cannot fabricate candidates: recheck the pick.
        any_eligible = any_eligible & (d_q_full < -opt_tol)

    # --- ratio test ---
    r, any_positive = _select_leaving(state.xB, w, state.basis, pricing, pivot_tol)
    new_status = _status(
        (~any_eligible, OPTIMAL), (~any_positive, UNBOUNDED), default=RUNNING
    )
    do_pivot = new_status == RUNNING
    if active is not None:
        do_pivot = do_pivot & active

    # --- basis change (product-form update).  The in-place writes below
    # touch only tensors created in this function. ---
    r1 = r.reshape(1)
    q1 = q.reshape(1)
    w_r = _at(w, r)
    safe_w_r = torch.where(do_pivot, w_r, 1.0)
    t = torch.clamp_min(_at(state.xB, r), 0.0) / safe_w_r
    Binv_r = _at(state.Binv, r) / safe_w_r
    Binv_new = state.Binv - torch.outer(w, Binv_r)
    Binv_new.index_copy_(0, r1, Binv_r.reshape(1, M))
    xB_new = state.xB - t * w
    xB_new.index_copy_(0, r1, t.reshape(1))

    leaving = _at(state.basis, r).to(torch.int64).reshape(1)
    basis_new = state.basis.clone().index_copy_(0, r1, q1.to(torch.int32))
    in_basis_new = cols.put(cols.put(state.in_basis.clone(), leaving, False), q, True)
    cB_new = cB.index_copy_(0, r1, c_q.reshape(1))  # cB is fresh

    # Incremental dual update pi' = pi + d_q rho_r; the objective is
    # recomputed as cB @ xB (the incremental form is wrong whenever the
    # Harris clamp zeroes a tolerance-negative leaving value).
    pi_new = state.pi + d_q_full * Binv_r
    obj_new = torch.matmul(cB_new, xB_new)

    # --- one fused pass over A_scan: next reduced costs and, for steepest
    # edge, the Goldfarb weights ---
    if pricing == PRICE_STEEPEST:
        gamma_q_val = (1.0 + torch.matmul(w, w)).to(scan_dtype)
        v = torch.matmul(w, state.Binv).to(scan_dtype)  # work vector, OLD inverse
        P = torch.stack(
            [pi_new.to(scan_dtype), v, _at(Binv_new, r).to(scan_dtype)]
        )
        d_next, gamma_new = fused_price_scan(P, A_scan, c_scan, gamma, gamma_q_val)
        g_leaving = torch.clamp_min(
            gamma_q_val / (safe_w_r * safe_w_r).to(scan_dtype), 1.0
        )
        gamma_new = cols.put(cols.put(gamma_new, leaving, g_leaving), q, 1.0)
        gamma_new = gamma_new.to(state.gamma.dtype)
    else:
        gamma_new = state.gamma
        d_next = c_scan - torch.matmul(pi_new.to(scan_dtype), A_scan)

    degen_new = torch.where(
        t <= degen_tol, state.degen_count + 1, 0
    ).to(torch.int32)

    def select(new, old):
        return torch.where(do_pivot, new, old)

    if active is None:
        status = new_status
        inner = state.inner + 1
    else:
        status = torch.where(active, new_status, state.status)
        inner = state.inner + active.to(torch.int32)
    return SimplexState(
        Binv=select(Binv_new, state.Binv),
        basis=select(basis_new, state.basis),
        xB=select(xB_new, state.xB),
        pi=select(pi_new, state.pi),
        obj=select(obj_new, state.obj),
        in_basis=select(in_basis_new, state.in_basis),
        gamma=select(gamma_new, state.gamma),
        iteration=state.iteration + do_pivot.to(torch.int32),
        status=status,
        degen_count=select(degen_new, state.degen_count),
        inner=inner,
        price_start=select((q + 1) % N, state.price_start).to(torch.int32),
        d=select(d_next, state.d),
    )


def make_iteration(
    pricing: int,
    opt_tol: float,
    pivot_tol: float,
    degen_tol: float,
    noisy_scan: bool = False,
):
    """One simplex iteration ``(state, A_scan, A_full, c, c_scan,
    candidate_mask) -> state``, as ``relp_tpu.simplex.kernels.make_iteration``
    builds it.  The port's scans are always full precision, so the JAX
    package's ``hi_scan`` polish mode has no counterpart."""

    def iteration(state, A_scan, A_full, c, c_scan, candidate_mask, shard=None):
        return _iteration(
            state, A_scan, A_full, c, c_scan, candidate_mask, None,
            pricing=pricing, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, noisy_scan=noisy_scan, shard=shard,
        )

    return iteration


def _chunk_entry(state: SimplexState, A_scan, c):
    """Reset the in-chunk counter and refresh the carried reduced costs
    (pi may have changed outside the loop)."""
    c_scan = c.to(A_scan.dtype)
    state = state._replace(
        inner=torch.zeros((), dtype=torch.int32, device=c.device),
        d=c_scan - torch.matmul(state.pi.to(A_scan.dtype), A_scan),
    )
    return state, c_scan


def run_chunk(
    state: SimplexState,
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
    noisy_scan: bool = False,
    shard=None,
    early_exit: Optional[bool] = None,
) -> SimplexState:
    """Run up to ``chunk`` pivots with no host read on CUDA.

    ``A_scan`` may be a lower-precision copy of ``A_full``; pass the same
    tensor twice for full precision.  ``stop_at_zero`` ends the walk once
    the objective is (near) zero: the phase-1 termination rule.  With a
    ``shard`` the column-sized inputs are this rank's block (see
    ``relp_tpu_torch.parallel.sharded``); the replicated state makes every
    rank take the same branches.  ``early_exit`` stops at the first
    inactive iteration, which reads the status on the host each iteration;
    by default it does so on the CPU only (a captured chunk passes False).
    """
    state, c_scan = _chunk_entry(state, A_scan, c)
    if early_exit is None:
        early_exit = A_scan.device.type == "cpu"
    for _ in range(chunk):
        active = state.status == RUNNING
        if stop_at_zero:
            active = active & (state.obj > 1e-9)
        if early_exit and not bool(active):
            break
        state = _iteration(
            state, A_scan, A_full, c, c_scan, candidate_mask, active,
            pricing=pricing, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, noisy_scan=noisy_scan, shard=shard,
        )
    return state


def _dual_iteration(
    state: SimplexState, A_scan, A_full, c, candidate_mask, active, *,
    pivot_tol: float, feas_tol: float, noisy_scan: bool,
) -> SimplexState:
    """One dual simplex iteration (leaving row: most negative basic value;
    entering: dual ratio test tie-broken toward the largest |alpha|)."""
    M, N = A_scan.shape
    scan_dtype = A_scan.dtype

    r = torch.argmin(state.xB)
    r1 = r.reshape(1)
    xB_r = _at(state.xB, r)
    feasible = xB_r >= -feas_tol

    # --- pivot row of the tableau: alpha = Binv[r] @ A ---
    rho = _at(state.Binv, r)
    alpha = torch.matmul(rho.to(scan_dtype), A_scan)
    d = state.d
    if noisy_scan and scan_dtype == torch.float32:
        alpha_floor = pivot_tol + _NOISY_F32_EPS * (1.0 + rho.abs().max()).to(
            scan_dtype
        )
    else:
        alpha_floor = pivot_tol
    eligible = candidate_mask & ~state.in_basis & (alpha < -alpha_floor)
    any_eligible = eligible.any()

    d_eff = torch.clamp_min(d, 0.0)
    ratio = torch.where(eligible, d_eff / (-alpha), float("inf"))
    tmin = ratio.min()
    near = eligible & (ratio <= tmin + 1e-7 * (1.0 + tmin.abs()))
    q = torch.argmax(torch.where(near, -alpha, float("-inf")))
    q1 = q.reshape(1)

    # --- FTRAN at working precision ---
    a_q = A_full.index_select(1, q1).reshape(M)
    w = torch.matmul(state.Binv, a_q)
    w_r = _at(w, r)
    pivot_ok = w_r < -pivot_tol

    new_status = _status(
        (feasible, OPTIMAL),
        (~any_eligible, INFEASIBLE),
        (~pivot_ok, SINGULAR),
        default=RUNNING,
    )
    do_pivot = (new_status == RUNNING) & active

    # --- basis change; in-place writes only on tensors made here ---
    safe_w_r = torch.where(do_pivot, w_r, 1.0)
    t = xB_r / safe_w_r  # >= 0: negative over negative
    Binv_r = rho / safe_w_r
    Binv_new = state.Binv - torch.outer(w, Binv_r)
    Binv_new.index_copy_(0, r1, Binv_r.reshape(1, M))
    xB_new = state.xB - t * w
    xB_new.index_copy_(0, r1, t.reshape(1))

    leaving = _at(state.basis, r).to(torch.int64).reshape(1)
    basis_new = state.basis.clone().index_copy_(0, r1, q1.to(torch.int32))
    in_basis_new = (
        state.in_basis.clone().index_fill_(0, leaving, False).index_fill_(0, q1, True)
    )

    # Dual price update: theta = d_q / (-alpha_q) >= 0.
    d_q_full = _at(c, q) - torch.matmul(state.pi, a_q)
    theta = d_q_full / (-safe_w_r)
    pi_new = state.pi - theta * rho
    theta_scan = theta.to(scan_dtype)
    d_next = d + theta_scan * alpha
    d_next.index_fill_(0, q1, 0.0)
    d_next.index_copy_(0, leaving, theta_scan.reshape(1))
    obj_new = torch.matmul(c.index_select(0, basis_new.to(torch.int64)), xB_new)

    def select(new, old):
        return torch.where(do_pivot, new, old)

    return state._replace(
        Binv=select(Binv_new, state.Binv),
        basis=select(basis_new, state.basis),
        xB=select(xB_new, state.xB),
        pi=select(pi_new, state.pi),
        obj=select(obj_new, state.obj),
        in_basis=select(in_basis_new, state.in_basis),
        iteration=state.iteration + do_pivot.to(torch.int32),
        status=torch.where(active, new_status, state.status),
        inner=state.inner + active.to(torch.int32),
        d=select(d_next, state.d),
    )


def make_dual_iteration(
    opt_tol: float, pivot_tol: float, feas_tol: float, noisy_scan: bool = False
):
    """One dual simplex iteration ``(state, A_scan, A_full, c, c_scan,
    candidate_mask) -> state`` (the port of make_dual_iteration)."""

    def iteration(state, A_scan, A_full, c, c_scan, candidate_mask):
        active = torch.ones((), dtype=torch.bool, device=c.device)
        return _dual_iteration(
            state, A_scan, A_full, c, candidate_mask, active,
            pivot_tol=pivot_tol, feas_tol=feas_tol, noisy_scan=noisy_scan,
        )

    return iteration


def dual_run_chunk(
    state: SimplexState,
    A_scan,
    A_full,
    c,
    candidate_mask,
    *,
    chunk: int,
    opt_tol: float,
    pivot_tol: float,
    feas_tol: float,
    noisy_scan: bool = False,
    early_exit: Optional[bool] = None,
) -> SimplexState:
    """Run up to ``chunk`` dual pivots with no host read on CUDA
    (``early_exit`` as in ``run_chunk``)."""
    state, _ = _chunk_entry(state, A_scan, c)
    if early_exit is None:
        early_exit = A_scan.device.type == "cpu"
    for _ in range(chunk):
        active = state.status == RUNNING
        if early_exit and not bool(active):
            break
        state = _dual_iteration(
            state, A_scan, A_full, c, candidate_mask, active,
            pivot_tol=pivot_tol, feas_tol=feas_tol, noisy_scan=noisy_scan,
        )
    return state


def basis_columns(A, c, basis, shard=None):
    """(B, c_B): the basis's columns of A and entries of c (exact; from
    their owners with a shard)."""
    return columns(shard, A.shape[-1], A.device).basis_columns(A, c, basis)


def _newton(B, X, b, cB, steps: int):
    """Newton-Schulz steps X <- X (2I - B X), then (X, xB, pi, obj,
    max|B X - I|)."""
    eye = torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
    for _ in range(steps):
        X = torch.matmul(X, 2.0 * eye - torch.matmul(B, X))
    residual = (torch.matmul(B, X) - eye).abs().max()
    xB = torch.matmul(X, b)
    pi = torch.matmul(cB, X)
    obj = torch.matmul(cB, xB)
    return X, xB, pi, obj, residual


def refactorize_from(B, cB, b, newton_steps: int):
    """``refactorize`` from the basis's (B, c_B)."""
    X = torch.linalg.inv_ex(B.to(torch.float32)).inverse.to(B.dtype)
    return _newton(B, X, b, cB, newton_steps)


def refactorize(A, b, c, basis, *, newton_steps: int = 3, shard=None):
    """Recompute the basis inverse: f32 inverse of B = A[:, basis], refined
    by Newton-Schulz in the working dtype.  Returns (Binv, xB, pi, obj,
    residual) with residual = max|B Binv - I|; a singular B gives a
    non-finite residual (``inv_ex`` does not raise)."""
    B, cB = basis_columns(A, c, basis, shard)
    return refactorize_from(B, cB, b, newton_steps)


def newton_refresh(Binv, A, b, c, basis, *, steps: int = 2, shard=None):
    """Refresh the carried inverse by Newton-Schulz steps from itself;
    returns (Binv, xB, pi, obj, residual) like ``refactorize``."""
    B, cB = basis_columns(A, c, basis, shard)
    return _newton(B, Binv, b, cB, steps)


def rademacher_probes(M: int, k: int, device) -> torch.Tensor:
    """The (M, k) +-1 probes of the JAX carry_health: bit 13 of the uint32
    hash i * 2654435761 + j * 40503, reproduced in int64 with the
    wraparound made explicit (& 0xFFFFFFFF)."""
    i = torch.arange(M, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(k, dtype=torch.int64, device=device)[None, :]
    ij = (i * 2654435761 + j * 40503) & 0xFFFFFFFF
    bit = ((ij >> 13) & 1).to(torch.bool)
    return torch.where(bit, 1.0, -1.0).to(torch.float64)


def carry_health(Binv, A, b, c, basis, xB, pi, shard=None):
    """f64 carry-health residual: the max of the relative residuals along
    b (feasibility), cB (duals) and four Rademacher probes."""
    f64 = torch.float64
    M = Binv.shape[0]
    B, cB = basis_columns(A, c, basis, shard)
    B = B.to(f64)
    b64 = b.to(f64)
    feas = (torch.matmul(B, xB.to(f64)) - b64).abs().max() / (
        1.0 + b64.abs().max()
    )
    cB64 = cB.to(f64)
    dual = (torch.matmul(pi.to(f64), B) - cB64).abs().max() / (
        1.0 + cB64.abs().max()
    )
    V = rademacher_probes(M, 4, Binv.device)
    XV = torch.matmul(Binv.to(f64), V)
    probe = (torch.matmul(B, XV) - V).abs().max() / (1.0 + XV.abs().max())
    return torch.maximum(feas, torch.maximum(dual, probe))


def recompute_gamma(Binv, A_scan, in_basis):
    """Exact steepest-edge weights gamma_j = 1 + ||Binv a_j||^2, in the
    scan precision (a full (M,M)x(M,N) matmul)."""
    W = torch.matmul(Binv.to(A_scan.dtype), A_scan)
    gamma = 1.0 + (W * W).sum(dim=0)
    return torch.where(in_basis, 1.0, gamma).to(Binv.dtype)


def tableau_row(Binv, A, r: int, shard=None):
    """Row r of the current tableau, Binv[r] @ A (gathered to the full
    width with a shard)."""
    return columns(shard, A.shape[1], A.device).gather(torch.matmul(Binv[r], A))


def reduced_costs(pi, A, c):
    return c - torch.matmul(pi, A)


def forced_pivot(state: SimplexState, A, c, q: int, r: int, shard=None) -> SimplexState:
    """Pivot column q in at row r unconditionally (zero-level pivots while
    driving artificials out).  q and r are host ints (q global)."""
    cols = columns(shard, A.shape[1], A.device)
    q_t = torch.tensor(q, device=A.device)
    a_q, c_q, cB = cols.fetch(A, c, q_t, state.basis)
    w = torch.matmul(state.Binv, a_q)
    w_r = w[r]
    t = state.xB[r] / w_r
    Binv_r = state.Binv[r] / w_r
    Binv_new = state.Binv - torch.outer(w, Binv_r)
    Binv_new[r] = Binv_r  # Binv_new is fresh
    xB_new = state.xB - t * w
    xB_new[r] = t
    leaving = state.basis[r].to(torch.int64).reshape(1)
    basis_new = state.basis.clone()
    basis_new[r] = q
    in_basis_new = cols.put(cols.put(state.in_basis.clone(), leaving, False), q_t, True)
    cB[r] = c_q  # cB is fresh
    return state._replace(
        Binv=Binv_new,
        basis=basis_new,
        xB=xB_new,
        pi=torch.matmul(cB, Binv_new),
        obj=torch.matmul(cB, xB_new),
        in_basis=in_basis_new,
        iteration=state.iteration + 1,
    )
