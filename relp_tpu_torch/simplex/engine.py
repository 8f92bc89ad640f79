"""Basis-inverse engines: the port of ``relp_tpu.simplex.engine``.

* :class:`DenseEngine`: explicit dense inverse with rank-1 product-form
  updates (the fast path).
* :class:`LUEngine`: f32 LU factors + eta ring (``simplex/lu.py``), the
  robustness and cross-check backend, ``basis_inverse="lu"``.
* :class:`DoubleFloatEngine`: the double-float (two-f32) carry of
  ``simplex/df_kernels.py``, ``carry="df32"``.

On a CUDA card every engine runs its chunks (the dense engine's primal and
dual ones) as captured CUDA graphs (``simplex/graphs.py``), replayed from
the process-wide cache by every later solve of the shape; under a mesh
the dense and LU chunks too, from a cache of the engine's own, their
collectives captured with them (the shard is a static argument of the
chunk).  On the CPU, and so under gloo, they run eagerly.
Refactorization, ``recompute_gamma`` and the forced pivot stay eager.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from relp_tpu_torch.simplex.lowering import DeviceProblem
from relp_tpu_torch.simplex.result import SolveStats
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.simplex import graphs, kernels
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


class _CapturedChunks:
    """Where an engine's captured chunks live: without a shard in the
    process-wide cache (``graphs.chunks()``), so that a later solve of the
    shape replays them; with one in a cache of the engine's own, which goes
    with the engine (every rank of a mesh would have to agree on each
    eviction of a cache that outlives a solve)."""

    shard = None
    _graphs: Optional[graphs.ChunkGraphs] = None

    def _chunk_graphs(self, state) -> Optional[graphs.ChunkGraphs]:
        """The cache of this engine's captured chunks when ``state`` lies on
        a card, sharded or not; None when the chunk runs eagerly (the
        CPU)."""
        if state[0].device.type not in graphs.DEVICE_TYPES:
            return None
        if self.shard is None:
            return graphs.chunks()
        if self._graphs is None:
            self._graphs = graphs.ChunkGraphs()
        return self._graphs


class DenseEngine(_CapturedChunks):
    name = "dense"

    # Relative f64 carry-health acceptance: a healthy f32 carry measures
    # ~1e-6..1e-5, a drifted or singular one 1e-3+.
    _health_tol = 3e-5
    # A FRESH f32 inverse whose health exceeds this is a genuine breakdown
    # (route to host f64); below it, it is the f32 floor of the basis.
    _floor_cap = 1e-3

    def __init__(self, device: torch.device, shard=None):
        self.device = device
        # A ``parallel.sharded.ColumnShard`` when the tableau is sharded by
        # column over a mesh: one engine per lowering (``make_engine``).
        self.shard = shard

    def init_state(self, problem: DeviceProblem, cfg: SolverConfig) -> SimplexState:
        state = self._init_state(problem, cfg)
        take = kernels.columns(self.shard, problem.N, self.device).take
        return state._replace(
            in_basis=take(state.in_basis), gamma=take(state.gamma), d=take(state.d)
        )

    def _init_state(self, problem: DeviceProblem, cfg: SolverConfig) -> SimplexState:
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
        shard = self.shard
        Binv, xB, pi, obj, residual = kernels.newton_refresh(
            state.Binv, A, b, c, state.basis, steps=2, shard=shard
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
            A, b, c, state.basis, newton_steps=newton, shard=shard
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
            Bm, cB_dev = kernels.basis_columns(A, c, state.basis, shard)
            B = Bm.to(torch.float64).cpu().numpy()
            try:
                Binv_h = np.linalg.inv(B)
            except np.linalg.LinAlgError:
                return state, float("inf")
            res = float(np.max(np.abs(B @ Binv_h - np.eye(B.shape[0]))))
            b_h = b.to(torch.float64).cpu().numpy()
            cB = cB_dev.to(torch.float64).cpu().numpy()
            xB_h = Binv_h @ b_h
            to_dev = lambda x: torch.as_tensor(x, device=A.device).to(A.dtype)  # noqa: E731
            Binv = to_dev(Binv_h)
            xB = to_dev(xB_h)
            pi = to_dev(cB @ Binv_h)
            obj = _scalar(float(cB @ xB_h), A.dtype, A.device)
        xB = self._clean_xB(xB, cfg)
        return state._replace(Binv=Binv, xB=xB, pi=pi, obj=obj), res

    def _carry_health(self, Binv, A, b, c, basis, xB, pi, cfg) -> Optional[float]:
        """f64 matvec health of a refreshed f32 carry (None for an f64
        carry, whose residual is already measured in f64)."""
        if cfg.dtype != "float32":
            return None
        return float(kernels.carry_health(Binv, A, b, c, basis, xB, pi, self.shard))

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
        kw = dict(
            pricing=mode,
            chunk=cfg.chunk_size,
            opt_tol=cfg.opt_tol,
            pivot_tol=cfg.pivot_tol,
            degen_tol=cfg.feas_tol,
            stop_at_zero=stop_at_zero,
            noisy_scan=kernels.noisy_f32_matmul(),
        )
        captured = self._chunk_graphs(state)
        run = kernels.run_chunk if captured is None else captured.run_chunk
        return run(state, A_scan, A_full, c, candidate_mask, shard=self.shard, **kw)

    def dual_run_chunk(self, state, A_scan, A_full, c, candidate_mask, cfg):
        if self.shard is not None:
            raise NotImplementedError(
                "the dual simplex does not run column-sharded (the JAX "
                "package turns the dual warm restart off under a mesh)"
            )
        kw = dict(
            chunk=cfg.chunk_size,
            opt_tol=cfg.opt_tol,
            pivot_tol=cfg.pivot_tol,
            feas_tol=cfg.feas_tol,
            noisy_scan=kernels.noisy_f32_matmul(),
        )
        captured = self._chunk_graphs(state)
        run = kernels.dual_run_chunk if captured is None else captured.dual_run_chunk
        return run(state, A_scan, A_full, c, candidate_mask, **kw)

    def recompute_gamma(self, state, A_scan):
        return state._replace(
            gamma=kernels.recompute_gamma(state.Binv, A_scan, state.in_basis)
        )

    def tableau_row(self, state, A, r: int) -> np.ndarray:
        return kernels.tableau_row(state.Binv, A, r, self.shard).cpu().numpy()

    def forced_pivot(self, state, A, c, q: int, r: int):
        return kernels.forced_pivot(state, A, c, q, r, self.shard)


class LUEngine(_CapturedChunks):
    name = "lu"

    def __init__(self, device: torch.device, shard=None):
        self.device = device
        # The lowering's ``parallel.sharded.ColumnShard`` under a mesh, as
        # for ``DenseEngine``.
        self.shard = shard

    def init_state(self, problem: DeviceProblem, cfg: SolverConfig) -> lu_mod.LUState:
        dtype = working_dtype(cfg)
        dev = self.device
        N = problem.N
        take = kernels.columns(self.shard, N, dev).take
        basis = problem.initial_basis
        in_basis = np.zeros(N, dtype=bool)
        in_basis[basis] = True
        basis_t = torch.as_tensor(np.asarray(basis, dtype=np.int32), device=dev)
        lu, piv, B0, eta_vals, eta_rows, xB, pi, obj, _residual = lu_mod.lu_refactorize(
            torch.as_tensor(take(problem.A), device=dev),
            torch.as_tensor(problem.b, device=dev),
            torch.as_tensor(take(problem.c_phase1), device=dev),
            basis_t,
            eta_capacity=cfg.refactor_period,
            shard=self.shard,
        )
        zero = _scalar(0, torch.int32, dev)
        return lu_mod.LUState(
            lu=lu, piv=piv, B0=B0, eta_vals=eta_vals, eta_rows=eta_rows,
            eta_count=zero, basis=basis_t, xB=xB, pi=pi, obj=obj,
            in_basis=torch.as_tensor(take(in_basis), device=dev),
            gamma=take(torch.ones(N, dtype=dtype, device=dev)),
            iteration=zero, status=_scalar(RUNNING, torch.int32, dev),
            inner=zero, price_start=zero,
        )

    def refactor(self, state, A, b, c, cfg: SolverConfig, stats: SolveStats):
        lu, piv, B0, eta_vals, eta_rows, xB, pi, obj, residual = lu_mod.lu_refactorize(
            A, b, c, state.basis, eta_capacity=cfg.refactor_period, shard=self.shard
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
        # prices with plain matvecs, not through the fused scan kernel.  On
        # a card the eta-ring kernels read the ring's fill on the device;
        # on the CPU the chunk reads it at entry to size the eta loops.
        kw = dict(
            pricing=mode, chunk=cfg.chunk_size, opt_tol=cfg.opt_tol,
            pivot_tol=cfg.pivot_tol, degen_tol=cfg.feas_tol,
            stop_at_zero=stop_at_zero,
        )
        captured = self._chunk_graphs(state)
        run = lu_mod.lu_run_chunk if captured is None else captured.lu_run_chunk
        return run(state, A_scan, A_full, c, candidate_mask, shard=self.shard, **kw)

    def recompute_gamma(self, state, A_scan):
        # gamma_j = 1 + ||B^-1 a_j||^2 from the B0 factors alone, which is
        # right only with an empty ring: a live eta would give weights of a
        # stale basis.  Column by column, so a shard's block is its own.
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
        cols = kernels.columns(self.shard, A.shape[1], A.device)
        return cols.gather(torch.matmul(rho, A)).cpu().numpy()

    def forced_pivot(self, state, A, c, q: int, r: int):
        return _lu_forced_pivot(state, A, c, q, r, self.shard)


def _lu_forced_pivot(state, A, c, q: int, r: int, shard=None):
    """Unconditional pivot for the LU engine (zero-level artificial
    drive-out): append the eta and update the bookkeeping.  q and r are
    host ints (q global).  ``_drive_out_artificials`` refactorizes before
    the ring would overflow."""
    cols = kernels.columns(shard, A.shape[1], A.device)
    k = int(state.eta_count)
    q_t = torch.tensor(q, device=A.device)
    a_q, c_q, cB = cols.fetch(A, c, q_t, state.basis)
    w = lu_mod.lu_ftran(state, a_q, k)
    d_q = c_q - torch.matmul(state.pi, a_q)
    t = state.xB[r] / w[r]
    xB_new = state.xB - t * w
    xB_new[r] = t  # xB_new is fresh
    leaving = state.basis[r].to(torch.int64).reshape(1)
    basis_new = state.basis.clone()
    basis_new[r] = q
    in_basis_new = cols.put(cols.put(state.in_basis.clone(), leaving, False), q_t, True)
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
    cB[r] = c_q  # cB is fresh
    return state._replace(
        basis=basis_new,
        xB=xB_new,
        pi=state.pi + d_q * rho_new,
        obj=torch.matmul(cB, xB_new),
        in_basis=in_basis_new,
        iteration=state.iteration + 1,
    )


class DoubleFloatEngine(_CapturedChunks):
    """Double-float (two-f32) carry: B^-1, x_B and pi as hi+lo pairs with
    compensated updates (``simplex/df_kernels``), f64-grade drift from f32
    operations.  The problem arrives as DfMatrix/DfVec pairs (the driver
    lowers in f64 and splits); the scans read the hi part."""

    name = "df32"

    def __init__(self, device: torch.device):
        self.device = device

    def init_state(self, problem: DeviceProblem, cfg: SolverConfig):
        from relp_tpu_torch.ops.df32 import df_from_f64
        from relp_tpu_torch.simplex.df_kernels import DfSimplexState

        dev = self.device
        M, N = problem.M, problem.N
        basis = problem.initial_basis
        in_basis = np.zeros(N, dtype=bool)
        in_basis[basis] = True
        b64 = np.asarray(problem.b, dtype=np.float64)
        cB = np.asarray(problem.c_phase1, dtype=np.float64)[basis]
        xh, xl = df_from_f64(b64, dev)  # the initial basis matrix is I
        pih, pil = df_from_f64(cB.copy(), dev)
        oh, ol = df_from_f64(np.float64(cB @ b64), dev)
        zero = _scalar(0, torch.int32, dev)
        return DfSimplexState(
            Binv=torch.eye(M, dtype=torch.float32, device=dev),
            Binv_lo=torch.zeros((M, M), dtype=torch.float32, device=dev),
            basis=torch.as_tensor(np.asarray(basis, dtype=np.int32), device=dev),
            xB=xh, xB_lo=xl, pi=pih, pi_lo=pil, obj=oh, obj_lo=ol,
            in_basis=torch.as_tensor(in_basis, device=dev),
            gamma=torch.ones(N, dtype=torch.float32, device=dev),
            iteration=zero,
            status=_scalar(RUNNING, torch.int32, dev),
            degen_count=zero, inner=zero, price_start=zero,
            d=torch.zeros(N, dtype=torch.float32, device=dev),
        )

    def refactor(self, state, A, b, c, cfg: SolverConfig, stats: SolveStats):
        from relp_tpu_torch.simplex.df_kernels import df_refactorize

        state, res = df_refactorize(state, A, b, c, cfg.feas_tol)
        stats.refactorizations += 1
        return state, res

    @staticmethod
    def _scan_of(A):
        from relp_tpu_torch.simplex.df_kernels import DfMatrix

        return A.hi if isinstance(A, DfMatrix) else A

    def run_chunk(
        self, state, A_scan, A_full, c, candidate_mask, mode, cfg,
        stop_at_zero=False,
    ):
        from relp_tpu_torch.simplex.df_kernels import df_run_chunk

        captured = self._chunk_graphs(state)
        run = df_run_chunk if captured is None else captured.df_run_chunk
        return run(
            state, self._scan_of(A_scan), A_full.hi, A_full.lo, c.hi, c.lo,
            candidate_mask, pricing=mode, chunk=cfg.chunk_size,
            opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol, degen_tol=cfg.feas_tol,
            stop_at_zero=stop_at_zero, noisy_scan=kernels.noisy_f32_matmul(),
        )

    def recompute_gamma(self, state, A_scan):
        return state._replace(
            gamma=kernels.recompute_gamma(
                state.Binv, self._scan_of(A_scan), state.in_basis
            )
        )

    def tableau_row(self, state, A, r: int) -> np.ndarray:
        from relp_tpu_torch.simplex.df_kernels import df_tableau_row

        return df_tableau_row(state, A, r).cpu().numpy()

    def forced_pivot(self, state, A, c, q: int, r: int):
        from relp_tpu_torch.simplex.df_kernels import df_forced_pivot

        return df_forced_pivot(state, A, c, q, r)


def make_engine(cfg: SolverConfig, device: torch.device, shard=None):
    """The engine of ``cfg``; ``shard`` is the lowering's column shard under
    a mesh, which the dense and LU engines take (the df32 carry is a
    single-device rescue path)."""
    if shard is not None and cfg.carry == "df32":
        raise ValueError("carry='df32' is a single-device rescue path")
    if cfg.carry == "df32":
        return DoubleFloatEngine(device)
    if cfg.basis_inverse == "lu":
        return LUEngine(device, shard)
    return DenseEngine(device, shard)
