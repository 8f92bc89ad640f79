"""Basis-inverse engines: the port of ``relp_tpu.simplex.engine``.

* :class:`DenseEngine`: explicit dense inverse with rank-1 product-form
  updates (the fast path).
* :class:`LUEngine`: f32 LU factors + eta ring (``simplex/lu.py``), the
  robustness and cross-check backend, ``basis_inverse="lu"``.

The double-float ``DoubleFloatEngine`` is ROADMAP work; ``make_engine``
raises for it rather than quietly using the dense engine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from relp_tpu_torch.simplex.lowering import DeviceProblem
from relp_tpu_torch.simplex.result import SolveStats
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.simplex import kernels
from relp_tpu_torch.simplex import lu as lu_mod
from relp_tpu_torch.simplex.state import RUNNING, SimplexState
from relp_tpu_torch.utils.logging import get_logger

_log = get_logger("engine")

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def working_dtype(cfg: SolverConfig) -> torch.dtype:
    return _TORCH_DTYPES[cfg.dtype]


def scan_dtype(cfg: SolverConfig) -> torch.dtype:
    if cfg.scan_dtype in ("same", cfg.dtype):
        return working_dtype(cfg)
    return _TORCH_DTYPES[cfg.scan_dtype]


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


class DenseEngine:
    name = "dense"

    # Relative f64 carry-health acceptance: a healthy f32 carry measures
    # ~1e-6..1e-5, a drifted or singular one 1e-3+.
    _health_tol = 3e-5
    # A FRESH f32 inverse whose health exceeds this is a genuine breakdown
    # (route to host f64); below it, it is the f32 floor of the basis.
    _floor_cap = 1e-3

    def __init__(self, device: torch.device):
        self.device = device

    def init_state(self, problem: DeviceProblem, cfg: SolverConfig) -> SimplexState:
        dtype = working_dtype(cfg)
        dev = self.device
        M, N = problem.M, problem.N
        basis = problem.initial_basis
        in_basis = np.zeros(N, dtype=bool)
        in_basis[basis] = True
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        xB = problem.b.astype(np_dtype)  # the initial basis matrix is I
        cB = problem.c_phase1[basis]
        zero = _scalar(0, torch.int32, dev)
        return SimplexState(
            Binv=torch.eye(M, dtype=dtype, device=dev),
            basis=torch.as_tensor(np.asarray(basis, dtype=np.int32), device=dev),
            xB=torch.as_tensor(xB, device=dev),
            pi=torch.as_tensor(cB.copy(), device=dev),
            obj=_scalar(float(cB @ xB), dtype, dev),
            in_basis=torch.as_tensor(in_basis, device=dev),
            gamma=torch.ones(N, dtype=dtype, device=dev),
            iteration=zero,
            status=_scalar(RUNNING, torch.int32, dev),
            degen_count=zero,
            inner=zero,
            price_start=zero,
            d=torch.zeros(N, dtype=scan_dtype(cfg), device=dev),
        )

    @staticmethod
    def _clean_xB(xB, cfg: SolverConfig):
        return torch.where(xB > -cfg.feas_tol, torch.clamp_min(xB, 0.0), xB)

    def refactor(
        self, state, A, b, c, cfg: SolverConfig, stats: SolveStats
    ) -> Tuple[SimplexState, float]:
        """Refresh the carried inverse: Newton refresh, then the f64 carry
        health second opinion, then a fresh refactorization, then host
        LAPACK in f64.  Returns (state, residual)."""
        Binv, xB, pi, obj, residual = kernels.newton_refresh(
            state.Binv, A, b, c, state.basis, steps=2
        )
        res = float(residual)
        if np.isfinite(res) and res <= self._accept_tol(A, cfg):
            stats.refactorizations += 1
            xB = self._clean_xB(xB, cfg)
            return state._replace(Binv=Binv, xB=xB, pi=pi, obj=obj), res

        # The f32 max|BX-I| itself floors at ~sqrt(m) eps |row|, so at
        # large m the gate above cannot pass; re-measure in f64 matvecs.
        health_r = self._carry_health(Binv, A, b, c, state.basis, xB, pi, cfg)
        if health_r is not None and health_r <= self._health_tol:
            _log.info(
                "refactor: Newton refresh accepted by f64 carry health "
                "%.3e (f32 residual floor was %.3e) at m=%d",
                health_r, res, A.shape[0],
            )
            stats.refactorizations += 1
            xB = self._clean_xB(xB, cfg)
            return state._replace(Binv=Binv, xB=xB, pi=pi, obj=obj), health_r

        newton = 3 if cfg.dtype == "float64" else 1
        Binv, xB, pi, obj, residual = kernels.refactorize(
            A, b, c, state.basis, newton_steps=newton
        )
        stats.refactorizations += 1
        res = float(residual)
        if not np.isfinite(res) or res > self._accept_tol(A, cfg):
            health_f = self._carry_health(Binv, A, b, c, state.basis, xB, pi, cfg)
            if health_f is not None and health_f <= self._floor_cap:
                # A fresh f32 inverse at the representation floor of this
                # basis: accepted, reported normalised to the floor.
                eff = min(health_f, self._health_tol)
                _log.info(
                    "refactor: fresh f32 inverse at its representation "
                    "floor (health %.3e <= cap %.0e) at m=%d; accepted, "
                    "reporting floor-normalized residual %.3e",
                    health_f, self._floor_cap, A.shape[0], eff,
                )
                xB = self._clean_xB(xB, cfg)
                return state._replace(Binv=Binv, xB=xB, pi=pi, obj=obj), eff
            _log.info(
                "refactor: device refactorize rejected (res %.3e, health "
                "%s), host LAPACK fallback at m=%d", res, health_f, A.shape[0],
            )
            basis_t = state.basis.to(torch.int64)
            basis = basis_t.cpu().numpy()
            B = A.index_select(1, basis_t).to(torch.float64).cpu().numpy()
            try:
                Binv_h = np.linalg.inv(B)
            except np.linalg.LinAlgError:
                return state, float("inf")
            res = float(np.max(np.abs(B @ Binv_h - np.eye(B.shape[0]))))
            b_h = b.to(torch.float64).cpu().numpy()
            cB = c.to(torch.float64).cpu().numpy()[basis]
            xB_h = Binv_h @ b_h
            to_dev = lambda x: torch.as_tensor(x, device=A.device).to(A.dtype)  # noqa: E731
            Binv = to_dev(Binv_h)
            xB = to_dev(xB_h)
            pi = to_dev(cB @ Binv_h)
            obj = _scalar(float(cB @ xB_h), A.dtype, A.device)
        xB = self._clean_xB(xB, cfg)
        return state._replace(Binv=Binv, xB=xB, pi=pi, obj=obj), res

    @staticmethod
    def _carry_health(Binv, A, b, c, basis, xB, pi, cfg) -> Optional[float]:
        """f64 matvec health of a refreshed f32 carry (None for an f64
        carry, whose residual is already measured in f64)."""
        if cfg.dtype != "float32":
            return None
        return float(kernels.carry_health(Binv, A, b, c, basis, xB, pi))

    @staticmethod
    def _accept_tol(A, cfg: SolverConfig) -> float:
        """Refactor acceptance residual; the f32 floor of max|BX-I| grows
        with m, so the gate does too (an order under the driver's 1e-4)."""
        if cfg.dtype == "float64":
            return 1e-6
        m = A.shape[0]
        return min(1e-5, max(1e-6, 4e-7 * float(m) ** 0.5))

    def run_chunk(
        self, state, A_scan, A_full, c, candidate_mask, mode, cfg,
        stop_at_zero=False,
    ):
        return kernels.run_chunk(
            state,
            A_scan,
            A_full,
            c,
            candidate_mask,
            pricing=mode,
            chunk=cfg.chunk_size,
            opt_tol=cfg.opt_tol,
            pivot_tol=cfg.pivot_tol,
            degen_tol=cfg.feas_tol,
            stop_at_zero=stop_at_zero,
            noisy_scan=kernels.noisy_f32_matmul(),
        )

    def dual_run_chunk(self, state, A_scan, A_full, c, candidate_mask, cfg):
        return kernels.dual_run_chunk(
            state,
            A_scan,
            A_full,
            c,
            candidate_mask,
            chunk=cfg.chunk_size,
            opt_tol=cfg.opt_tol,
            pivot_tol=cfg.pivot_tol,
            feas_tol=cfg.feas_tol,
            noisy_scan=kernels.noisy_f32_matmul(),
        )

    def recompute_gamma(self, state, A_scan):
        return state._replace(
            gamma=kernels.recompute_gamma(state.Binv, A_scan, state.in_basis)
        )

    def tableau_row(self, state, A, r: int) -> np.ndarray:
        return kernels.tableau_row(state.Binv, A, r).cpu().numpy()

    def forced_pivot(self, state, A, c, q: int, r: int):
        return kernels.forced_pivot(state, A, c, q, r)


class LUEngine:
    name = "lu"

    def __init__(self, device: torch.device):
        self.device = device

    def init_state(self, problem: DeviceProblem, cfg: SolverConfig) -> lu_mod.LUState:
        dtype = working_dtype(cfg)
        dev = self.device
        N = problem.N
        basis = problem.initial_basis
        in_basis = np.zeros(N, dtype=bool)
        in_basis[basis] = True
        basis_t = torch.as_tensor(np.asarray(basis, dtype=np.int32), device=dev)
        lu, piv, B0, eta_vals, eta_rows, xB, pi, obj, _residual = lu_mod.lu_refactorize(
            torch.as_tensor(problem.A, device=dev),
            torch.as_tensor(problem.b, device=dev),
            torch.as_tensor(problem.c_phase1, device=dev),
            basis_t,
            eta_capacity=cfg.refactor_period,
        )
        zero = _scalar(0, torch.int32, dev)
        return lu_mod.LUState(
            lu=lu, piv=piv, B0=B0, eta_vals=eta_vals, eta_rows=eta_rows,
            eta_count=zero, basis=basis_t, xB=xB, pi=pi, obj=obj,
            in_basis=torch.as_tensor(in_basis, device=dev),
            gamma=torch.ones(N, dtype=dtype, device=dev),
            iteration=zero, status=_scalar(RUNNING, torch.int32, dev),
            inner=zero, price_start=zero,
        )

    def refactor(self, state, A, b, c, cfg: SolverConfig, stats: SolveStats):
        lu, piv, B0, eta_vals, eta_rows, xB, pi, obj, residual = lu_mod.lu_refactorize(
            A, b, c, state.basis, eta_capacity=cfg.refactor_period
        )
        stats.refactorizations += 1
        state = state._replace(
            lu=lu, piv=piv, B0=B0, eta_vals=eta_vals, eta_rows=eta_rows,
            eta_count=torch.zeros_like(state.eta_count),
            xB=DenseEngine._clean_xB(xB, cfg), pi=pi, obj=obj,
        )
        return state, float(residual)

    def run_chunk(
        self, state, A_scan, A_full, c, candidate_mask, mode, cfg,
        stop_at_zero=False,
    ):
        # d is recomputed per pivot from pi (no carried d), so the LU path
        # prices with plain matvecs, not through the fused scan kernel.
        return lu_mod.lu_run_chunk(
            state, A_scan, A_full, c, candidate_mask, pricing=mode,
            chunk=cfg.chunk_size, opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
            degen_tol=cfg.feas_tol, stop_at_zero=stop_at_zero,
        )

    def recompute_gamma(self, state, A_scan):
        # gamma_j = 1 + ||B^-1 a_j||^2 from the B0 factors alone, which is
        # right only with an empty ring: a live eta would give weights of a
        # stale basis.
        assert int(state.eta_count) == 0, (
            "LUEngine.recompute_gamma requires a fresh factorization "
            "(empty eta ring); refactor first"
        )
        W = lu_mod._solve32(state.lu, state.piv, A_scan, trans=0)
        gamma = 1.0 + (W * W).sum(dim=0).to(state.gamma.dtype)
        return state._replace(gamma=torch.where(state.in_basis, 1.0, gamma))

    def tableau_row(self, state, A, r: int) -> np.ndarray:
        e_r = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
        e_r[r] = 1.0
        rho = lu_mod.lu_btran(state, e_r, int(state.eta_count))
        return torch.matmul(rho, A).cpu().numpy()

    def forced_pivot(self, state, A, c, q: int, r: int):
        return _lu_forced_pivot(state, A, c, q, r)


def _lu_forced_pivot(state, A, c, q: int, r: int):
    """Unconditional pivot for the LU engine (zero-level artificial
    drive-out): append the eta and update the bookkeeping.  q and r are
    host ints; the driver refactorizes before the ring would overflow."""
    k = int(state.eta_count)
    a_q = A[:, q]
    w = lu_mod.lu_ftran(state, a_q, k)
    d_q = c[q] - torch.matmul(state.pi, a_q)
    t = state.xB[r] / w[r]
    xB_new = state.xB - t * w
    xB_new[r] = t  # xB_new is fresh
    leaving = state.basis[r].to(torch.int64).reshape(1)
    basis_new = state.basis.clone()
    basis_new[r] = q
    in_basis_new = state.in_basis.clone().index_fill_(0, leaving, False)
    in_basis_new[q] = True
    eta_vals = state.eta_vals.clone()
    eta_vals[k] = w
    eta_rows = state.eta_rows.clone()
    eta_rows[k] = r
    state = state._replace(
        eta_vals=eta_vals, eta_rows=eta_rows, eta_count=state.eta_count + 1
    )
    e_r = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    e_r[r] = 1.0
    rho_new = lu_mod.lu_btran(state, e_r, k + 1)
    cB = c.index_select(0, basis_new.to(torch.int64))
    return state._replace(
        basis=basis_new,
        xB=xB_new,
        pi=state.pi + d_q * rho_new,
        obj=torch.matmul(cB, xB_new),
        in_basis=in_basis_new,
        iteration=state.iteration + 1,
    )


def make_engine(cfg: SolverConfig, device: torch.device):
    if cfg.carry == "df32":
        raise NotImplementedError(
            "carry='df32' (DoubleFloatEngine) is not ported to relp_tpu_torch "
            "yet: ROADMAP.md Queue 1, 'ops/df32.py + simplex/df_kernels.py'"
        )
    if cfg.basis_inverse == "lu":
        return LUEngine(device)
    return DenseEngine(device)
