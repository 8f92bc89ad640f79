"""Host-side solve orchestration: the port of ``relp_tpu.simplex.driver``.

Phase 1 minimises the artificial cost; zero-level artificials are driven
out and rows where that is impossible are removed (rank repair); phase 2
runs the real costs; the device runs chunks of pivots and the host reads
the state once per chunk, refactorizes, switches to Bland's rule on
degeneracy stalls, and finally certifies the basis exactly with the port's
own copy of the exact certifier, ``relp_tpu_torch.exact.certify``.

Deliberate differences from the JAX driver:

* f64 is native on CUDA and the CPU, so ``_f64_is_emulated()`` is False and
  the escalation ladder is f32 -> f64 (no double-float rung).
* f32 matmuls are true f32, so an OPTIMAL reached mid-chunk is final: the
  JAX driver's noisy-backend polish branch has no counterpart.
* ``mesh`` (a ``DeviceMesh`` of ``relp_tpu_torch.parallel.make_mesh``)
  shards the tableau by column over its "col" axis with the collectives
  written out (``relp_tpu_torch.parallel.sharded``); every rank runs the
  same host code on the same replicated state and returns the same result.
  The JAX driver's gates under a mesh hold: no ``host_sparse`` route by
  "auto", no dual restart of a warm basis, no df32 (it raises).  Both the
  dense and the LU engine run sharded.  The ``host_sparse`` backend is
  chosen by ``"auto"`` only on the CPU
  (``host_sparse.should_use_host_sparse``), never on CUDA.
* The LU engine's state has no ``degen_count`` and no dual iteration, so
  the Bland trigger and the dual warm restart apply to the dense engine
  only, as in the JAX driver.
"""

from __future__ import annotations

import dataclasses
import time
from fractions import Fraction
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch

from relp_tpu_torch.data.elements import LinearProgramError, LPStatus, Objective
from relp_tpu_torch.data.solution import Solution
from relp_tpu_torch.exact.certify import (
    certify_and_repair,
    certify_infeasible,
    certify_unbounded,
)
from relp_tpu_torch.linalg.sparse import SparseVector
from relp_tpu_torch.providers.base import MatrixProvider
from relp_tpu_torch.simplex.lowering import (
    DeviceProblem,
    lower_provider,
    lower_removing_rows,
)
from relp_tpu_torch.simplex.result import (
    OptimizationResult,
    SolveStats,
    SolveStatus,
)
from relp_tpu_torch.utils.debug import validate_bfs_state
from relp_tpu_torch.config import SolverConfig, default_config, torch_device
from relp_tpu_torch.simplex.engine import make_engine, scan_dtype
from relp_tpu_torch.simplex.host_sparse import (
    should_use_host_sparse,
    solve_relaxation_host_sparse,
)
from relp_tpu_torch.simplex.kernels import (
    PRICE_BLAND,
    PRICE_DANTZIG,
    PRICE_FIRST,
    PRICE_FIRST_MEMORY,
    PRICE_STEEPEST,
)
from relp_tpu_torch.simplex.state import (
    OPTIMAL,
    RUNNING,
    SINGULAR,
    UNBOUNDED,
    state_to_numpy,
)
from relp_tpu_torch.utils import logging as trace
from relp_tpu_torch.utils.logging import get_logger

_log = get_logger("driver")

_PRICING_CODES = {
    "dantzig": PRICE_DANTZIG,
    "steepest": PRICE_STEEPEST,
    "first": PRICE_FIRST,
    "first_memory": PRICE_FIRST_MEMORY,
}


def _np_dtype(cfg: SolverConfig):
    return np.float64 if cfg.dtype == "float64" else np.float32


def _lower_dtype(cfg: SolverConfig):
    # The df32 carry lowers the problem in f64 and splits it into hi/lo
    # pairs, so the data is as accurate as the compensated carry.
    return np.float64 if cfg.carry == "df32" else _np_dtype(cfg)


def _with_status(state, code: int):
    return state._replace(
        status=torch.tensor(code, dtype=torch.int32, device=state.status.device)
    )


def _device_arrays(problem: DeviceProblem, cfg: SolverConfig, device, shard=None):
    """Device tensors of the lowered problem: (A, A_scan, b, c1, c2, mask).
    A_scan is A itself unless the scan dtype differs from the working one.
    For carry="df32" the f64 lowering is split into DfMatrix/DfVec hi+lo
    pairs, and A_scan is the hi part (the f32 scan copy).  With a column
    ``shard`` the column-sized arrays are this rank's block (b is
    replicated)."""
    if shard is not None:
        A = shard.take(problem.A)
        sdt = scan_dtype(cfg)
        return (A, A if sdt == A.dtype else A.to(sdt),
                torch.as_tensor(problem.b, device=device),
                shard.take(problem.c_phase1), shard.take(problem.c_phase2),
                shard.take(problem.candidate_mask))
    mask = torch.as_tensor(problem.candidate_mask, device=device)
    if cfg.carry == "df32":
        from relp_tpu_torch.ops.df32 import df_from_f64
        from relp_tpu_torch.simplex.df_kernels import DfMatrix, DfVec

        A = DfMatrix(*df_from_f64(problem.A, device))
        b = DfVec(*df_from_f64(problem.b, device))
        c1 = DfVec(*df_from_f64(problem.c_phase1, device))
        c2 = DfVec(*df_from_f64(problem.c_phase2, device))
        return A, A.hi, b, c1, c2, mask
    A = torch.as_tensor(problem.A, device=device)
    sdt = scan_dtype(cfg)
    A_scan = A if sdt == A.dtype else A.to(sdt)
    b = torch.as_tensor(problem.b, device=device)
    c1 = torch.as_tensor(problem.c_phase1, device=device)
    c2 = torch.as_tensor(problem.c_phase2, device=device)
    return A, A_scan, b, c1, c2, mask


def _validate(state, A, b, c, feas_tol: float, shard=None) -> None:
    """The shared BFS invariant check, on host copies of the state."""
    fields = state_to_numpy(state)
    if shard is not None:  # the full width of every column-sized array
        for name in ("in_basis", "gamma", "d"):
            fields[name] = shard.gather(getattr(state, name)).cpu().numpy()
        A, c = shard.gather(A), shard.gather(c)
    validate_bfs_state(
        SimpleNamespace(**fields),
        A.cpu().numpy(), b.cpu().numpy(), c.cpu().numpy(),
        feas_tol=feas_tol,
    )


def _host_columns(engine, x) -> np.ndarray:
    """A column-sized state member on the host, at the full width."""
    shard = getattr(engine, "shard", None)
    return (x if shard is None else shard.gather(x)).cpu().numpy()


class _ChunkSpans:
    """The chunk loop's spans: ``chunk`` from ``run_chunk``'s call to the
    loop's first host read of the state it returns (the synchronisation),
    and ``chunk.exit`` from there to the next call or the phase's return.
    A chunk's pivots are the change of the iteration count between the
    reads of it that the loop and its caller make anyway: ``settle`` adds
    them to the chunk's span at the first read after it."""

    def __init__(self):
        self.chunk = self.exit = self.pending = None
        self.it0 = 0

    def run(self, it0: int) -> None:
        """``run_chunk`` is called on a state of ``it0`` pivots."""
        trace.end(self.exit)
        self.exit = None
        self.chunk, self.it0 = trace.start("chunk"), it0

    def synced(self) -> None:
        """The loop's first host read of the chunk's state has returned."""
        trace.end(self.chunk)
        self.pending, self.chunk = self.chunk, None
        self.exit = trace.start("chunk.exit")

    def settle(self, iteration: int) -> int:
        """The iteration count the loop has just read; returned."""
        if self.pending is not None:
            self.pending.count(pivots=iteration - self.it0)
            self.pending = None
        return iteration

    def close(self) -> None:
        """The phase returns."""
        trace.end(self.exit)
        self.exit = None


def _run_phase(
    engine,
    state,
    problem: DeviceProblem,
    A_scan,
    A_full,
    b,
    c,
    candidate_mask,
    cfg: SolverConfig,
    stats: SolveStats,
    chunks: _ChunkSpans,
    stop_at_zero: bool = False,
):
    """Run chunks until the phase terminates.

    With a lower-precision scan copy, an OPTIMAL verdict is *polished*: the
    loop continues with full-precision scans until optimal there too.
    """
    pricing = _PRICING_CODES[cfg.pricing]
    mixed = A_scan is not A_full
    if pricing == PRICE_STEEPEST:
        state = engine.recompute_gamma(state, A_scan)

    bland_mode = False
    polishing = False
    max_chunks = max(1, cfg.max_iterations // max(1, cfg.chunk_size)) + 2
    last_obj: Optional[float] = None
    stall_chunks = 0
    # EXPAND-style anti-degeneracy: when even Bland stalls, shift the basic
    # values by a tiny deterministic positive jitter; the shift is removed
    # (refactor against the true b) once the perturbed walk terminates.
    perturbed = False
    perturb_episodes = 0
    chunk_exits = 0

    def _jitter(state):
        M = state.xB.shape[0]
        idx = np.arange(M)
        eps = 1e-7 * (1.0 + ((idx * 37) % 19) / 19.0)
        return state._replace(
            xB=state.xB + torch.as_tensor(eps, device=state.xB.device).to(state.xB.dtype)
        )

    def _breakdown(residual) -> bool:
        return not np.isfinite(residual) or residual > 1e-4

    nan_retries = 0
    for _ in range(max_chunks):
        mode = PRICE_BLAND if bland_mode else pricing
        scan = A_full if polishing else A_scan
        it_before = chunks.settle(int(state.iteration))
        state_entry = state
        chunks.run(it_before)
        state = engine.run_chunk(
            state, scan, A_full, c, candidate_mask, mode, cfg,
            stop_at_zero=stop_at_zero,
        )
        stats.chunks += 1
        finite = np.isfinite(float(state.obj))
        chunks.synced()
        if not finite:
            # One catastrophic pivot can blow the product-form carry to
            # inf/nan mid-chunk.  The chunk-entry state is still good: roll
            # back, clean the carry, and retry once with a conservative
            # pivot tolerance.
            nan_retries += 1
            _log.info(
                "chunk exploded to nan (retry %d): rolling back %d pivots, "
                "retrying with pivot_tol=1e-5",
                nan_retries, chunks.settle(int(state.iteration)) - it_before,
            )
            if nan_retries > 3:
                state = _with_status(state_entry, SINGULAR)
                break
            state, residual = engine.refactor(state_entry, A_full, b, c, cfg, stats)
            if _breakdown(residual):
                state = _with_status(state, SINGULAR)
                break
            safe_cfg = dataclasses.replace(cfg, pivot_tol=max(cfg.pivot_tol, 1e-5))
            chunks.run(it_before)
            state = engine.run_chunk(
                state, scan, A_full, c, candidate_mask, mode, safe_cfg,
                stop_at_zero=stop_at_zero,
            )
            stats.chunks += 1
            finite = np.isfinite(float(state.obj))
            chunks.synced()
            if not finite:
                state = _with_status(state, SINGULAR)
                break
        status = int(state.status)
        if stop_at_zero and float(state.obj) <= 1e-9:
            break  # phase 1 reached zero artificial cost: feasible

        # Degenerate-vertex stall detection: a stalled objective over whole
        # chunks switches to Bland's rule until progress resumes.
        obj = float(state.obj)
        progressed = last_obj is None or (last_obj - obj) > 1e-12 * (1.0 + abs(obj))
        last_obj = obj
        if progressed:
            stall_chunks = 0
            if bland_mode and status == RUNNING:
                bland_mode = False
        elif status == RUNNING:
            stall_chunks += 1
            if stall_chunks >= 2:
                bland_mode = True
            if stall_chunks >= 4 and not perturbed and perturb_episodes < 3:
                perturbed = True
                perturb_episodes += 1
                bland_mode = False
                stall_chunks = 0
                state = _jitter(state)
                continue
        if status != RUNNING and perturbed:
            # Remove the shift and polish on the true right-hand side.
            perturbed = False
            state, residual = engine.refactor(state, A_full, b, c, cfg, stats)
            if _breakdown(residual):
                state = _with_status(state, SINGULAR)
                break
            if pricing == PRICE_STEEPEST:
                state = engine.recompute_gamma(state, scan)
            state = _with_status(state, RUNNING)
            last_obj = None
            continue
        if status == OPTIMAL and mixed and not polishing:
            # Low-precision scans said optimal; continue at full precision.
            polishing = True
            state, residual = engine.refactor(state, A_full, b, c, cfg, stats)
            if _breakdown(residual):
                state = _with_status(state, SINGULAR)
                break
            if pricing == PRICE_STEEPEST:
                state = engine.recompute_gamma(state, A_full)
            state = _with_status(state, RUNNING)
            continue
        if status != RUNNING:
            break

        degen = getattr(state, "degen_count", None)
        if degen is not None and int(degen) >= cfg.bland_threshold:
            bland_mode = True

        state, residual = engine.refactor(state, A_full, b, c, cfg, stats)
        if _breakdown(residual):
            # The chunk walked into a (near-)singular basis: roll back and
            # retry it with a conservative pivot tolerance.
            nan_retries += 1
            _log.info(
                "refactor breakdown after chunk (res %s, retry %d): "
                "rolling back %d pivots, retrying with pivot_tol=1e-5",
                residual, nan_retries, chunks.settle(int(state.iteration)) - it_before,
            )
            recovered = False
            if nan_retries <= 3:
                state_rb, res_rb = engine.refactor(
                    state_entry, A_full, b, c, cfg, stats
                )
                if not _breakdown(res_rb):
                    safe_cfg = dataclasses.replace(
                        cfg, pivot_tol=max(cfg.pivot_tol, 1e-5)
                    )
                    chunks.run(it_before)
                    state_rb = engine.run_chunk(
                        state_rb, scan, A_full, c, candidate_mask, mode,
                        safe_cfg, stop_at_zero=stop_at_zero,
                    )
                    stats.chunks += 1
                    # The refactorization's residual is this chunk's first
                    # host read.
                    state_rb, res_rb = engine.refactor(
                        state_rb, A_full, b, c, cfg, stats
                    )
                    chunks.synced()
                    if not _breakdown(res_rb):
                        state = state_rb
                        recovered = True
            if not recovered:
                state = _with_status(state, SINGULAR)
                break
        if cfg.debug_validate and hasattr(state, "Binv"):
            if cfg.carry == "df32":
                _validate(state, A_full.hi, b.hi, c.hi,
                          feas_tol=max(cfg.feas_tol, 1e-5) * 1e4)
            else:
                _validate(state, A_full, b, c, feas_tol=cfg.feas_tol * 1e4,
                          shard=getattr(engine, "shard", None))
        if perturbed:
            state = _jitter(state)  # refactor recomputed xB from the true b
        chunk_exits += 1
        if pricing == PRICE_STEEPEST and (
            chunk_exits % max(1, cfg.gamma_refresh_period) == 0
        ):
            state = engine.recompute_gamma(state, scan)
        if chunks.settle(int(state.iteration)) >= cfg.max_iterations:
            break

    chunks.close()
    return state


def _run_dual_phase(
    engine, state, A_scan, A_full, b, c, candidate_mask,
    cfg: SolverConfig, stats: SolveStats, chunks: _ChunkSpans,
):
    """Dual simplex pivots until primal feasibility is restored (the basis
    must be dual feasible).  Anything but OPTIMAL sends the caller to a
    cold start, so exact certification stays the only source of negative
    verdicts.  ``state`` is a fresh one, of 0 pivots."""
    max_chunks = max(1, cfg.max_iterations // max(1, cfg.chunk_size)) + 2
    iteration = 0
    for _ in range(max_chunks):
        chunks.run(iteration)
        state = engine.dual_run_chunk(state, A_scan, A_full, c, candidate_mask, cfg)
        stats.chunks += 1
        running = int(state.status) == RUNNING
        chunks.synced()
        if not running:
            break
        state, residual = engine.refactor(state, A_full, b, c, cfg, stats)
        if not np.isfinite(residual) or residual > 1e-4:
            state = _with_status(state, SINGULAR)
            break
        iteration = chunks.settle(int(state.iteration))
        if iteration >= cfg.max_iterations:
            break
    chunks.close()
    return state


def _drive_out_artificials(
    engine, state, problem: DeviceProblem, A, b, c, cfg: SolverConfig,
    stats: SolveStats,
):
    """Pivot zero-level artificials out of the basis; return the redundant
    rows (reference: remove_artificial_basis_variables)."""
    basis = state.basis.cpu().numpy()
    artificial_rows = [
        i for i in range(problem.m_real) if basis[i] >= problem.art_offset
    ]
    redundant: List[int] = []
    for r in artificial_rows:
        row = engine.tableau_row(state, A, r)
        in_basis = _host_columns(engine, state.in_basis)
        candidates = np.where(
            (~in_basis[: problem.n_real]) & (np.abs(row[: problem.n_real]) > 1e-7)
        )[0]
        if candidates.size:
            q = int(candidates[np.argmax(np.abs(row[candidates]))])
            # The LU engine's eta ring has a fixed capacity: refactorize
            # before it would overflow.
            eta_count = getattr(state, "eta_count", None)
            if eta_count is not None and int(eta_count) >= cfg.refactor_period - 1:
                state, _res = engine.refactor(state, A, b, c, cfg, stats)
            state = engine.forced_pivot(state, A, c, q, r)
        else:
            redundant.append(r)
    return state, redundant


def _f64_is_emulated() -> bool:
    """False: f64 is native on CUDA and the CPU, so the escalation ladder
    goes from f32 straight to f64 (no double-float rung)."""
    return False


def solve_relaxation(
    provider: MatrixProvider,
    config: Optional[SolverConfig] = None,
    *,
    warm_start_basis: Optional[List[int]] = None,
    mesh=None,
) -> OptimizationResult:
    """Two-phase revised simplex over a provider, with the f32 -> f64
    escalation ladder on numerical breakdown or an uncertified verdict.

    ``warm_start_basis`` is a provider-column index per structural row; a
    feasible basis skips phase 1, a dual-feasible one restores primal
    feasibility by dual pivots, anything else cold-starts.

    ``mesh`` (``relp_tpu_torch.parallel.make_mesh``) shards the tableau by
    column over its "col" axis; call it on every rank of the mesh.
    """
    cfg0 = config or default_config()
    device = torch_device(cfg0)
    if cfg0.backend == "host_sparse" or (
        cfg0.backend == "auto"
        and mesh is None
        and should_use_host_sparse(provider, cfg0, device)
    ):
        # Host scipy code (f64 + exact certification), whichever device the
        # configuration names; "auto" picks it only on the CPU.
        result = solve_relaxation_host_sparse(
            provider, cfg0, warm_start_basis=warm_start_basis
        )
        if not hasattr(result, "provider"):
            result.provider = provider  # type: ignore[attr-defined]
        return result

    result = _solve_relaxation_once(provider, cfg0, warm_start_basis, mesh)
    # __post_init__ clamps tolerances in place for f32; escalation restores
    # the requested (pre-clamp) values.
    tol_reset = getattr(cfg0, "requested_tolerances", {})
    if result.status is SolveStatus.NUMERICAL_ERROR:
        ladder = []
        if (
            cfg0.dtype == "float32"
            and cfg0.carry == "native"
            and mesh is None
            and _f64_is_emulated()
        ):
            ladder.append(
                dataclasses.replace(
                    cfg0, carry="df32",
                    refactor_period=min(cfg0.refactor_period, 100),
                    chunk_size=min(cfg0.chunk_size, 100), **tol_reset,
                )
            )
        ladder.append(
            dataclasses.replace(
                cfg0, dtype="float64", carry="native",
                refactor_period=min(cfg0.refactor_period, 60),
                chunk_size=min(cfg0.chunk_size, 60), **tol_reset,
            )
        )
        ladder.append(
            dataclasses.replace(
                cfg0, dtype="float64", carry="native", refactor_period=30,
                chunk_size=30, scan_dtype="same",
                **{
                    **tol_reset,
                    "pivot_tol": max(tol_reset.get("pivot_tol", cfg0.pivot_tol), 1e-7),
                },
            )
        )
        applied: List[str] = []
        for retry_cfg in ladder:
            applied.append("df32" if retry_cfg.carry == "df32" else retry_cfg.dtype)
            _log.info("escalation (numerical error): entering rung %s", applied[-1])
            result = _solve_relaxation_once(provider, retry_cfg, warm_start_basis, mesh)
            result.stats.escalations = list(applied)
            _log.info(
                "rung %s: status=%s certified=%s iters=%d", applied[-1],
                result.status.value, result.stats.certified, result.stats.iterations,
            )
            # Keep climbing while the verdict is uncertified: a rung can
            # return a wrong but non-numerical verdict.
            if result.status is not SolveStatus.NUMERICAL_ERROR and (
                not cfg0.certify or result.stats.certified
            ):
                break
    elif (
        cfg0.dtype == "float32"
        and cfg0.certify
        and result.status
        in (
            SolveStatus.ITERATION_LIMIT,
            SolveStatus.FINITE_OPTIMUM,
            SolveStatus.INFEASIBLE,
            SolveStatus.UNBOUNDED,
        )
        and not result.stats.certified
    ):
        # The f32 path found something uncertifiable: re-solve at f64,
        # warm-started from the best basis so far.
        ladder = []
        if cfg0.carry == "native" and mesh is None and _f64_is_emulated():
            ladder.append(dataclasses.replace(cfg0, carry="df32", **tol_reset))
        ladder.append(
            dataclasses.replace(cfg0, dtype="float64", carry="native", **tol_reset)
        )
        _log.info(
            "escalation (uncertified %s at f32): climbing the ladder",
            result.status.value,
        )
        applied = []
        for retry_cfg in ladder:
            applied.append("df32" if retry_cfg.carry == "df32" else retry_cfg.dtype)
            # The previous basis is a usable warm start only when it still
            # matches the full provider: rank repair shrinks it, and
            # INFEASIBLE/phase-1 bases may hold artificial indices.
            warm = warm_start_basis
            if (
                result.basis
                and not result.stats.removed_rows
                and (
                    result.art_offset is None
                    or all(j < result.art_offset for j in result.basis)
                )
            ):
                warm = result.basis
            result = _solve_relaxation_once(provider, retry_cfg, warm, mesh)
            result.stats.escalations = list(applied)
            _log.info(
                "rung %s: status=%s certified=%s iters=%d", applied[-1],
                result.status.value, result.stats.certified, result.stats.iterations,
            )
            if result.stats.certified:
                break
    # The provider the verdict refers to (the inner solve attaches the
    # rank-repaired one its basis indexes; never clobber it).
    if not hasattr(result, "provider"):
        result.provider = provider  # type: ignore[attr-defined]
    return result


def warm_dual_feasible(A, c, basis_full, nonbasic_mask, opt_tol):
    """Host f64 dual-feasibility check for warm-start engagement (the JAX
    package's rule, on numpy copies): solve B^T pi = c_B in f64 and
    tolerate data-quantisation-scale negative reduced costs.

    Returns (dual_feasible, dmin, tol).
    """
    A64 = np.asarray(A, dtype=np.float64)
    c64 = np.asarray(c, dtype=np.float64)
    B64 = A64[:, basis_full]
    try:
        pi64 = np.linalg.solve(B64.T, c64[basis_full])
    except np.linalg.LinAlgError:
        return False, -np.inf, float(opt_tol)
    d = c64 - pi64 @ A64
    tol = max(
        float(opt_tol),
        32.0 * float(np.finfo(np.float32).eps) * (1.0 + float(np.abs(pi64).max())),
    )
    masked = d[nonbasic_mask]
    dmin = float(masked.min()) if masked.size else 0.0
    return dmin >= -tol, dmin, tol


def _solve_relaxation_once(
    provider: MatrixProvider,
    config: Optional[SolverConfig] = None,
    warm_start_basis: Optional[List[int]] = None,
    mesh=None,
) -> OptimizationResult:
    """One attempt at one configuration, as one ``solve`` span."""
    with trace.span("solve") as solve:
        result = _solve_once(provider, config, warm_start_basis, mesh)
        stats = result.stats
        solve.count(pivots=stats.iterations + stats.dual_iterations,
                    chunks=stats.chunks)
    return result


def _solve_once(provider, config, warm_start_basis, mesh) -> OptimizationResult:
    cfg = config or default_config()
    device = torch_device(cfg)
    if mesh is not None and cfg.carry == "df32":
        raise ValueError("carry='df32' is a single-device rescue path")
    stats = SolveStats()
    t_start = time.perf_counter()
    dtype = _lower_dtype(cfg)
    chunks = _ChunkSpans()

    with trace.span("lower"):
        problem = lower_provider(
            provider, dtype=dtype, pad_to=cfg.pad_to, equilibrate=cfg.prescale
        )

    def place(problem):
        """The engine of this lowering (with a mesh, its column shard
        follows the lowering's N) and its device arrays."""
        with trace.span("place"):
            shard = None
            if mesh is not None:
                from relp_tpu_torch.parallel.sharded import column_shard

                shard = column_shard(mesh, problem.N, device)
            return (make_engine(cfg, device, shard),
                    _device_arrays(problem, cfg, device, shard))

    engine, (A, A_scan, b, c1, c2, candidate_mask) = place(problem)

    warm_started = False
    cold_basis = problem.initial_basis.copy()
    if warm_start_basis is not None:
        if len(warm_start_basis) != problem.m_real:
            raise ValueError(
                f"warm_start_basis has {len(warm_start_basis)} entries, "
                f"the problem has {problem.m_real} rows"
            )
        warm = cold_basis.copy()
        warm[: problem.m_real] = np.asarray(warm_start_basis, dtype=np.int32)
        problem.initial_basis = warm
        state = engine.init_state(problem, cfg)
        state, residual = engine.refactor(state, A, b, c2, cfg, stats)
        xB = state.xB.cpu().numpy()
        basis_ok = np.isfinite(residual) and residual < 1e-4
        if basis_ok and float(xB.min()) > -1e-7:
            warm_started = True
        elif (
            basis_ok
            and cfg.dual_restart
            and mesh is None
            and hasattr(engine, "dual_run_chunk")
        ):
            # Primal infeasible warm basis (the rhs changed since it was
            # optimal): if still dual feasible, dual pivots restore primal
            # feasibility with no phase 1.
            nonbasic = problem.candidate_mask & ~state.in_basis.cpu().numpy()
            dual_feasible, _, _ = warm_dual_feasible(
                problem.A, problem.c_phase2, state.basis.cpu().numpy(),
                nonbasic, cfg.opt_tol,
            )
            restored = False
            if dual_feasible:
                # Chunk spans of their own: a dual chunk that ends other
                # than optimal is never settled by a later read.
                dual_chunks = _ChunkSpans()
                state = _run_dual_phase(
                    engine, state, A_scan, A, b, c2, candidate_mask, cfg, stats,
                    dual_chunks,
                )
                if int(state.status) == OPTIMAL:
                    stats.dual_iterations = dual_chunks.settle(int(state.iteration))
                    # Phase 2 re-verifies optimality under the configured
                    # pricing rule.
                    state = _with_status(state, RUNNING)
                    warm_started = True
                    restored = True
            if not restored:
                problem.initial_basis = cold_basis
        else:
            problem.initial_basis = cold_basis

    if not warm_started:
        state = engine.init_state(problem, cfg)

    # --- phase 1 (skipped when slack pivots cover every row) ---
    needs_phase1 = not warm_started and bool(
        np.any(problem.initial_basis[: problem.m_real] >= problem.art_offset)
    )
    if needs_phase1:
        state = _run_phase(
            engine, state, problem, A_scan, A, b, c1, candidate_mask, cfg,
            stats, chunks, stop_at_zero=True,
        )
        stats.phase1_iterations = chunks.settle(int(state.iteration))
        status = int(state.status)
        feasible = float(state.obj) <= cfg.phase1_tol
        if status == SINGULAR:
            return _finish(cfg, stats, t_start, SolveStatus.NUMERICAL_ERROR)
        if status == RUNNING and not feasible:
            return _finish(cfg, stats, t_start, SolveStatus.ITERATION_LIMIT)
        if status == UNBOUNDED:
            # The phase-1 objective is bounded below by 0: no blocking row
            # here is float noise, not a ray.
            return _finish(cfg, stats, t_start, SolveStatus.NUMERICAL_ERROR)
        if not feasible:
            phase1_basis = None
            if cfg.certify:
                basis_np = state.basis.cpu().numpy()
                phase1_basis = [int(basis_np[i]) for i in range(problem.m_real)]
                with trace.timed("certify") as clock:
                    stats.certified = certify_infeasible(
                        problem.provider, phase1_basis, problem.art_offset
                    )
                stats.certify_time_s += clock.seconds
            result = _finish(
                cfg, stats, t_start, SolveStatus.INFEASIBLE,
                basis=phase1_basis, art_offset=problem.art_offset,
            )
            result.provider = problem.provider  # type: ignore[attr-defined]
            return result

        state, _residual = engine.refactor(state, A, b, c1, cfg, stats)
        state, redundant = _drive_out_artificials(
            engine, state, problem, A, b, c1, cfg, stats
        )
        if redundant:
            # Rank repair: rebuild without the redundant rows.
            stats.removed_rows = redundant
            old_basis = state.basis.cpu().numpy()
            removed = set(redundant)
            keep = [i for i in range(problem.m_real) if i not in removed]
            with trace.span("lower"):
                problem = lower_removing_rows(
                    problem, redundant, dtype=dtype, pad_to=cfg.pad_to
                )
            new_basis = problem.initial_basis.copy()
            for new_i, old_i in enumerate(keep):
                j = int(old_basis[old_i])
                if j < problem.n_real:
                    new_basis[new_i] = j
            problem.initial_basis = new_basis
            engine, (A, A_scan, b, c1, c2, candidate_mask) = place(problem)
            state = engine.init_state(problem, cfg)

        # Phase transition: real costs, fresh factorization.
        state, residual = engine.refactor(state, A, b, c2, cfg, stats)
        if not np.isfinite(residual) or residual > 1e-4:
            return _finish(cfg, stats, t_start, SolveStatus.NUMERICAL_ERROR)
        state = _with_status(state, RUNNING)

    # --- phase 2 ---
    state = _run_phase(
        engine, state, problem, A_scan, A, b, c2, candidate_mask, cfg, stats, chunks
    )
    stats.iterations = chunks.settle(int(state.iteration))
    status = int(state.status)
    if status == SINGULAR:
        return _finish(cfg, stats, t_start, SolveStatus.NUMERICAL_ERROR)
    if status == RUNNING:
        return _finish(cfg, stats, t_start, SolveStatus.ITERATION_LIMIT)
    if status == UNBOUNDED:
        structural = None
        if cfg.certify:
            basis_np = state.basis.cpu().numpy()
            structural = [int(basis_np[i]) for i in range(problem.m_real)]
            with trace.timed("certify") as clock:
                stats.certified = certify_unbounded(
                    problem.provider, structural, art_offset=problem.art_offset
                )
            stats.certify_time_s += clock.seconds
        result = _finish(
            cfg, stats, t_start, SolveStatus.UNBOUNDED,
            basis=structural, art_offset=problem.art_offset,
        )
        result.provider = problem.provider  # type: ignore[attr-defined]
        return result

    # --- extract the BFS over provider columns ---
    basis_np = state.basis.cpu().numpy()
    xB_np = state.xB.to(torch.float64).cpu().numpy()
    obj_val = float(state.obj)
    if hasattr(state, "xB_lo"):  # df32 carry: collapse the hi+lo pairs
        xB_np = xB_np + state.xB_lo.to(torch.float64).cpu().numpy()
        obj_val += float(state.obj_lo)
    entries = []
    structural_basis: List[int] = []
    for i in range(problem.m_real):
        j = int(basis_np[i])
        structural_basis.append(j)
        if j < problem.n_real and abs(xB_np[i]) > cfg.zero_tol:
            value = xB_np[i]
            if problem.col_scale is not None:
                value *= problem.col_scale[j]  # undo equilibration
            entries.append((j, value))

    result = OptimizationResult(
        status=SolveStatus.FINITE_OPTIMUM,
        bfs=None,
        objective=obj_val,
        basis=structural_basis,
        stats=stats,
    )
    result.float_entries = entries  # type: ignore[attr-defined]
    result.provider = problem.provider  # type: ignore[attr-defined]
    result.removed_rows = stats.removed_rows  # type: ignore[attr-defined]

    if cfg.certify:
        with trace.timed("certify") as clock:
            certify_and_repair(result, problem.provider, structural_basis, cfg)
        stats.certify_time_s += clock.seconds
    else:
        result.bfs = SparseVector(
            [(j, Fraction(float(v))) for j, v in entries], problem.n_real
        )

    stats.wall_time_s = time.perf_counter() - t_start
    return result


def _finish(
    cfg: SolverConfig, stats: SolveStats, t_start: float, status: SolveStatus,
    *, basis=None, art_offset=None,
) -> OptimizationResult:
    stats.wall_time_s = time.perf_counter() - t_start
    return OptimizationResult(
        status=status, stats=stats, basis=basis, art_offset=art_offset
    )


def solve_general_form(
    general_form, config: Optional[SolverConfig] = None
) -> Tuple[OptimizationResult, Optional[Solution]]:
    """Full pipeline on a GeneralForm: presolve -> standardize -> solve ->
    reconstruct.  Returns (result, Solution or None), as one ``request``
    span."""
    with trace.span("request"):
        return _solve_general_form(general_form, config)


def _solve_general_form(general_form, config):
    cfg = config or default_config()
    gf = general_form

    if cfg.presolve:
        try:
            with trace.span("presolve"):
                gf.presolve()
        except LinearProgramError as exc:
            stats = SolveStats()
            if exc.status is LPStatus.FINITE_OPTIMUM:
                result = OptimizationResult(
                    status=SolveStatus.FINITE_OPTIMUM, stats=stats
                )
                result.stats.certified = True
                solution = exc.payload
                # The presolve payload is in the original sense; report the
                # minimize-form convention like the simplex path.
                if gf.objective is Objective.MAXIMIZE and solution is not None:
                    solution = Solution(
                        -solution.objective_value, solution.solution_values
                    )
                return result, solution
            if exc.status is LPStatus.INFEASIBLE:
                return OptimizationResult(SolveStatus.INFEASIBLE, stats=stats), None
            return OptimizationResult(SolveStatus.UNBOUNDED, stats=stats), None

    with trace.span("standardize"):
        counts = gf.standardize()
        matrix_data = gf.derive_matrix_data(counts)
    result = solve_relaxation(matrix_data, cfg)
    if not result.is_optimal():
        return result, None

    with trace.span("reconstruct"):
        reduced = result.exact_bfs if result.exact_bfs is not None else result.bfs
        reduced = matrix_data.reconstruct_solution(reduced)
        solution = gf.compute_full_solution_with_reduced_solution(reduced)
    return result, solution
