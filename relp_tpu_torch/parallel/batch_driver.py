"""Batched scenario solves: the port of ``relp_tpu.parallel.batch_driver``.

All providers are lowered to a common padded shape; phase 1 and phase 2 run
as batched chunk loops with per-LP freezing, refactorization is batched, and
every LP is certified exactly on the host with the shared
``certify_and_repair``.

Scope, as in the JAX package: artificials left basic at zero level after
phase 1 are not driven out per LP (the certifier treats them as identity
columns at cost 0 whose exact value must be zero); LPs that hit numerical
trouble or keep clearly nonzero artificials fall back to the single-LP
driver, which has the full rank-repair machinery.

Differences from the JAX driver:

* ``mesh`` shards the scenarios over its "batch" axis (when the count
  divides it, else they are replicated) and every LP's columns over "col",
  with the collectives written out (``relp_tpu_torch.parallel.sharded``).
  Each rank certifies its own scenarios, the host's loop decisions are
  all-reduced over the world, and every rank returns the whole list.  As
  in the JAX package, the batched-pivot kernels and the dual warm restart
  stay off under a mesh.
* There is no persistent compile cache to enable: the port compiles no
  program, and its kernel library is cached by source hash.  What the JAX
  package jits at module scope, the port captures once a process: on a
  card, ``_batch_step`` (both routes), the dual chunk and the polish chunk
  replay CUDA graphs from ``graphs.steps()``, the process-wide cache
  bounded by bytes, so that repeated calls of one shape (a MIP's node
  waves) capture each once; a step runs eagerly at its key's first use,
  so that a one-off call pays no capture for a step it takes once.  The
  cache keeps a shared tableau as one (M, N) slice and reads B stacked
  tableaus in place, releasing them when the call's steps are done.  The
  batched refactorization (``_v_refactor``: torch's batched ``inv_ex``)
  stays eager on every device: at the families' shapes torch runs it
  through MAGMA, which a capture refuses.  The CPU, and so gloo, runs
  every step eagerly.
* Under a mesh on cards the sharded steps replay too, their collectives
  captured, from ``graphs.steps(group)``, the cache of the mesh's column
  group.  Its keys hold the shard by value (``ColumnShard`` equality), so
  a second call of one shape under one mesh replays the first call's
  graphs.  Every rank of the group must capture, replay or run eagerly
  the same step at the same point, or their collectives stop matching:
  the ranks run the same steps in the same order (the host's loop
  decisions are all-reduced), so the keys' first and second uses fall
  alike, and the one fact that differs between ranks, the bytes the cache
  holds (column blocks of different widths when N is not a multiple of
  the ranks), is agreed before every eviction as its largest value over
  the group (a MAX all_reduce on the host).
* The report of each chunk is the host's one read per chunk; the chunk
  itself reads nothing on CUDA.
"""

from __future__ import annotations

import dataclasses
import os as _os
import time
from fractions import Fraction
from typing import List, Optional, Sequence

import numpy as np
import torch

from relp_tpu_torch.config import SolverConfig, default_config, torch_device
from relp_tpu_torch.exact.certify import certify_and_repair
from relp_tpu_torch.linalg.device import pad_to_multiple
from relp_tpu_torch.linalg.sparse import SparseVector
from relp_tpu_torch.parallel.batch import (
    _megakernel_variant,
    _v_gamma,
    _v_newton,
    _v_refactor,
    batched_dual_run_chunk,
    batched_run_chunk,
    make_batch_state,
    megakernel_applicable,
    megakernel_run_chunk,
)
from relp_tpu_torch.simplex.driver import _PRICING_CODES, warm_dual_feasible
from relp_tpu_torch.simplex import graphs
from relp_tpu_torch.simplex.engine import DenseEngine, scan_dtype
from relp_tpu_torch.providers.base import MatrixProvider
from relp_tpu_torch.simplex.kernels import PRICE_STEEPEST, noisy_f32_matmul
from relp_tpu_torch.simplex.lowering import lower_provider
from relp_tpu_torch.simplex.result import OptimizationResult, SolveStats, SolveStatus
from relp_tpu_torch.simplex.state import OPTIMAL, RUNNING, SINGULAR
from relp_tpu_torch.utils import logging as trace
from relp_tpu_torch.utils.logging import get_logger

_log = get_logger("batch")


def _steps(shard):
    """The cache of captured steps: the process-wide one, or under a mesh
    the one of the shard's column group."""
    return graphs.steps(None if shard is None else shard.group)


def run_step(body, state, inputs, *, graphed: bool, must_launch=None, **static):
    """``body(state, **inputs, **static)``: replayed from the process-wide
    cache of captured steps when ``graphed`` (a card), with the
    fixed-length loop (``early_exit=False``); else run eagerly.  A stacked
    tableau (three dimensions, batch stride not 0) is read in place, not
    copied into the cache; ``solve_batch`` releases it when its steps are
    done.  Every device step of ``solve_batch`` goes through here."""
    if graphed:
        stacked = tuple(role for role, x in inputs.items()
                        if x.dim() == 3 and x.stride(0) != 0)
        return _steps(static.get("shard")).run(
            body, state, inputs, must_launch=must_launch, bound=stacked,
            early_exit=False, **static)
    return body(state, **inputs, **static)


def _batch_step(
    batch, A_scan, A, b, c, cand, *,
    pricing, chunk, opt_tol, pivot_tol, degen_tol, noisy_scan,
    stop_at_zero, hi_scan, mega,
    newton_steps, feas_tol, refactor_period, use_steepest, shard=None,
    early_exit=None,
):
    """One chunk of pivots, then the Newton-Schulz refresh and the gamma
    refresh, returning (new batch, (4, B) report of status, obj, iteration
    and re-arm flags): the host reads only the report.  ``early_exit`` as
    in ``batched_run_chunk`` (on the kernel route, the plain version's)."""
    it_before = batch.iteration
    if mega:
        batch = megakernel_run_chunk(
            batch, A, c, cand, stop_at_zero=stop_at_zero, chunk=chunk,
            opt_tol=opt_tol, pivot_tol=pivot_tol, degen_tol=degen_tol,
            early_exit=early_exit,
        )
    else:
        batch = batched_run_chunk(
            batch, A_scan, A, c, cand, stop_at_zero=stop_at_zero,
            pricing=pricing, chunk=chunk, opt_tol=opt_tol,
            pivot_tol=pivot_tol, degen_tol=degen_tol, noisy_scan=noisy_scan,
            refactor_period=refactor_period,
            b=b if refactor_period > 0 else None,
            newton_steps=newton_steps, feas_tol=feas_tol, shard=shard,
            early_exit=early_exit,
        )
    rearm = torch.zeros_like(batch.status, dtype=torch.bool)
    if noisy_scan and not hi_scan:
        # With noisy in-chunk scans an OPTIMAL reached after pivots this chunk
        # may be a scan-noise freeze: re-arm it, and the host switches the
        # phase to polish chunks.  Dormant in the port (noisy_f32_matmul()
        # is False), kept as the JAX package has it.
        rearm = (batch.status == OPTIMAL) & (batch.iteration > it_before)
        batch = batch._replace(status=torch.where(rearm, RUNNING, batch.status))
    report = torch.stack([
        batch.status.to(A.dtype),
        batch.obj.to(A.dtype),
        batch.iteration.to(A.dtype),
        rearm.to(A.dtype),
    ])
    Binv, xB, pi, obj, residual = _v_newton(
        batch.Binv, A, b, c, batch.basis, steps=2 if newton_steps <= 1 else 3,
        shard=shard,
    )
    xB = torch.where(xB > -feas_tol, torch.clamp_min(xB, 0.0), xB)
    # Numerical breakdown (a NaN or diverged carry): freeze the LP as
    # SINGULAR; it falls back per LP at extraction.
    broke = ~torch.isfinite(residual) | (residual > 1.0)
    batch = batch._replace(
        Binv=Binv, xB=xB, pi=pi, obj=obj,
        status=torch.where(
            broke & (batch.status == RUNNING), SINGULAR, batch.status
        ).to(batch.status.dtype),
    )
    if use_steepest:
        batch = batch._replace(gamma=_v_gamma(Binv, A_scan, batch.in_basis))
    return batch, report


def lower_batch(providers, cfg: SolverConfig, device, *, shared_structure: bool):
    """Lower every provider to one common padded shape and build the
    starting batch state (slack/artificial basis, phase-1 costs).

    Returns (problems, A, b, c1, c2, cand, batch), the arrays stacked over
    the batch on ``device``.  With ``shared_structure`` the tableau is
    lowered once and only b differs per scenario: ``A`` is then that one
    (M, N) tableau expanded to (B, M, N), batch stride 0, not B copies.
    Nothing writes into it (an in-place write into an expanded tensor
    raises); cast it with :func:`cast_tableau`.
    """
    dtype = np.float64 if cfg.dtype == "float64" else np.float32
    max_rows = max(p.nr_rows() for p in providers)
    probe_M = pad_to_multiple(max(max_rows, 1), cfg.pad_to)
    max_cols = max(p.nr_columns() + probe_M for p in providers)
    lower = dict(dtype=dtype, pad_to=cfg.pad_to, equilibrate=cfg.prescale,
                 min_rows=max_rows, min_cols=max_cols)
    if shared_structure:
        base = lower_provider(providers[0], **lower)
        problems = []
        for p in providers:
            b_k = np.zeros(base.M, dtype=dtype)
            for i, v in enumerate(p.right_hand_side()):
                b_k[i] = float(v)
            if base.row_scale is not None:
                b_k *= base.row_scale
            problems.append(dataclasses.replace(base, b=b_k, provider=p))
    else:
        problems = [lower_provider(p, **lower) for p in providers]
    M, N = problems[0].M, problems[0].N
    assert all(pr.A.shape == (M, N) for pr in problems)

    def stacked(field):
        return torch.as_tensor(np.stack([getattr(pr, field) for pr in problems]),
                               device=device)

    if shared_structure:
        A = torch.as_tensor(base.A, device=device).expand(len(problems), M, N)
    else:
        A = stacked("A")

    # Initial states are built on the host and moved in one copy per field.
    host_engine = DenseEngine(torch.device("cpu"))
    batch = make_batch_state([host_engine.init_state(pr, cfg) for pr in problems])
    batch = type(batch)(*(t.to(device) for t in batch))
    return (problems, A, stacked("b"), stacked("c_phase1"),
            stacked("c_phase2"), stacked("candidate_mask"), batch)


def cast_tableau(A: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``A`` in ``dtype``, one shared tableau staying one: the (M, N) base
    is cast and expanded again (a cast of the expanded view would make B
    copies)."""
    if A.shape[0] > 1 and A.stride(0) == 0:
        return A[0].to(dtype).expand(A.shape)
    return A.to(dtype)


def solve_batch(
    providers: Sequence[MatrixProvider],
    config: Optional[SolverConfig] = None,
    *,
    certify: Optional[bool] = None,
    shared_structure: bool = False,
    mesh=None,
    warm_start_basis: Optional[Sequence[int]] = None,
) -> List[OptimizationResult]:
    """Solve a batch of LPs in lockstep on one device.

    ``certify`` overrides the config's exact-certification flag
    (certification runs per LP on the host).

    ``shared_structure=True`` declares that all providers share the
    constraint matrix and costs and differ only in the right-hand side (the
    perturbed-scenario case): the tableau is lowered once.

    ``warm_start_basis`` (one basis, a provider column per structural row,
    e.g. ``result.basis`` of the unperturbed base problem) engages the
    batched dual-simplex warm restart: every scenario starts from that basis
    and dual pivots restore per-LP primal feasibility, skipping both phases
    (``cfg.dual_restart``).  When the basis is not dual feasible for every
    scenario, the cold path runs; LPs that prove infeasible by a dual ray
    fall back per LP, so verdicts and certificates are unchanged.

    The cold phases run their chunks through the batched-pivot kernels
    wherever ``megakernel_applicable`` holds (f32, steepest edge, M % 8,
    N % 128, a Hopper variant that fits), and through the batched torch
    path otherwise; ``cfg.pallas_batch`` is kept for configuration
    compatibility and selects nothing.

    ``mesh`` (``relp_tpu_torch.parallel.make_mesh``) shards the scenarios
    over its "batch" axis when their count divides it (else every rank
    holds all of them) and each LP's columns over "col"; call it on every
    rank of the mesh, which all return the whole list.

    The call is one ``batch`` span, which counts its LPs and their pivots.
    """
    with trace.span("batch") as span:
        results = _solve_batch(
            providers, config, certify=certify, shared_structure=shared_structure,
            mesh=mesh, warm_start_basis=warm_start_basis,
        )
        span.count(lps=len(results), pivots=sum(
            r.stats.iterations + r.stats.dual_iterations for r in results))
    return results


def _solve_batch(providers, config, *, certify, shared_structure, mesh,
                 warm_start_basis) -> List[OptimizationResult]:
    cfg = config or default_config()
    if certify is None:
        certify = cfg.certify
    device = torch_device(cfg)
    problems, A, b, c1, c2, cand, batch = lower_batch(
        providers, cfg, device, shared_structure=shared_structure
    )
    M, N = problems[0].M, problems[0].N
    mixed = cfg.scan_dtype not in ("same", cfg.dtype)
    A_scan = cast_tableau(A, scan_dtype(cfg)) if mixed else A
    c2_host = c2.cpu().numpy()
    shard = None
    lo, hi = 0, len(problems)
    if mesh is not None:
        from relp_tpu_torch.parallel.sharded import (
            batch_block,
            column_shard,
            shard_batch_problem,
            shard_batch_state,
        )

        # This rank's scenarios [lo, hi) and column block of each.
        lo, hi = batch_block(mesh, len(problems))
        shard = column_shard(mesh, N, device)
        A, b, c1, cand, A_scan_s = shard_batch_problem(
            mesh, A, b, c1, cand, A_scan=A_scan if mixed else None
        )
        A_scan = A_scan_s if mixed else A
        c2 = shard.take(c2[lo:hi])
        batch = shard_batch_state(mesh, batch)
    my_providers = list(providers)[lo:hi]
    problems = problems[lo:hi]

    newton = 3 if cfg.dtype == "float64" else 1
    noisy_backend = noisy_f32_matmul()
    pricing = _PRICING_CODES[cfg.pricing]
    kwargs = dict(
        pricing=pricing,
        chunk=cfg.chunk_size,
        opt_tol=cfg.opt_tol,
        pivot_tol=cfg.pivot_tol,
        degen_tol=cfg.feas_tol,
        noisy_scan=noisy_backend,
    )
    # In-chunk refactorization cadence (batched_run_chunk): 0 unless
    # device_refactor; the batched-pivot kernels ignore it.
    in_chunk_period = cfg.refactor_period if cfg.device_refactor else 0

    def refactor(batch, c):
        Binv, xB, pi, obj, residual = _v_refactor(
            A, b, c, batch.basis, newton_steps=newton, shard=shard
        )
        xB = torch.where(xB > -cfg.feas_tol, torch.clamp_min(xB, 0.0), xB)
        return batch._replace(Binv=Binv, xB=xB, pi=pi, obj=obj), residual

    use_megakernel = megakernel_applicable(
        A, cfg.dtype, cfg.scan_dtype, pricing, mesh
    )
    graphed = device.type in graphs.DEVICE_TYPES
    if not use_megakernel:
        _log.info(
            "no batched-pivot kernel takes %s (dtype %s, scan %s, pricing "
            "%s); the batched torch path runs",
            tuple(A.shape), cfg.dtype, cfg.scan_dtype, cfg.pricing,
        )

    def step(batch, c, stop_at_zero, hi_scan, mega):
        return run_step(
            _batch_step, batch, dict(A_scan=A_scan, A=A, b=b, c=c, cand=cand),
            graphed=graphed,
            must_launch=_megakernel_variant(A.shape) if mega else None,
            stop_at_zero=stop_at_zero, hi_scan=hi_scan, mega=mega,
            newton_steps=newton, feas_tol=cfg.feas_tol,
            refactor_period=in_chunk_period,
            use_steepest=pricing == PRICE_STEEPEST, shard=shard, **kwargs,
        )

    def world_any(*flags):
        """The host's loop decisions, the same on every rank: each flag
        or-ed over the world (ranks hold different scenarios)."""
        if mesh is None:
            return flags
        import torch.distributed as dist

        from relp_tpu_torch.parallel.sharded import all_reduce

        t = torch.tensor([float(f) for f in flags], device=device)
        all_reduce(t, op=dist.ReduceOp.MAX)
        return tuple(bool(v) for v in t.cpu().numpy() > 0)

    max_chunks = min(max(1, cfg.max_iterations // max(1, cfg.chunk_size)) + 2, 60)

    def run_phase(batch, c, stop_at_zero, mega=None):
        if pricing == PRICE_STEEPEST:
            batch = batch._replace(gamma=_v_gamma(batch.Binv, A_scan, batch.in_basis))
        # No per-LP Bland/perturbation machinery here: LPs still RUNNING after
        # the cap fall back to the single-LP driver.
        hi = False
        for _ in range(max_chunks):
            batch, report = step(
                batch, c, stop_at_zero, hi,
                use_megakernel if mega is None else mega,
            )
            report = report.cpu().numpy()
            status = report[0].astype(np.int32)
            obj = report[1]
            running = status == RUNNING
            if stop_at_zero:
                running = running & (obj > 1e-9)
            any_running, at_limit, any_rearmed = world_any(
                running.any(), report[2].max() >= cfg.max_iterations,
                report[3].max() > 0,
            )
            if not any_running or at_limit:
                break
            if not hi and any_rearmed:
                hi = True  # scan-noise freezes: polish chunks from here
        # The returned state is freshly refreshed (basis-exact xB/pi/obj).
        return batch

    def with_status(batch, status):
        return batch._replace(
            status=torch.as_tensor(status.astype(np.int32), device=device)
        )

    def try_warm_dual(batch):
        """Start every scenario from ``warm_start_basis`` and restore per-LP
        primal feasibility with batched dual pivots.  Returns (batch, per-LP
        dual pivot counts), or (batch, None) when the basis is not dual
        feasible for every scenario (all or nothing keeps the loops
        uniform)."""
        m_real = problems[0].m_real
        if any(pr.m_real != m_real for pr in problems):
            return batch, None  # heterogeneous rows: one shared basis is undefined
        if len(warm_start_basis) != m_real:
            raise ValueError(
                f"warm_start_basis has {len(warm_start_basis)} entries for "
                f"{m_real} structural rows"
            )
        warm_full = problems[0].initial_basis.copy()
        warm_full[:m_real] = np.asarray(warm_start_basis, dtype=np.int32)
        in_b = np.zeros(N, dtype=bool)
        in_b[warm_full] = True
        Bsz = len(problems)
        wb = batch._replace(
            basis=torch.as_tensor(warm_full, dtype=torch.int32, device=device)
            .repeat(Bsz, 1),
            in_basis=torch.as_tensor(in_b, device=device).repeat(Bsz, 1),
        )
        wb, residual = refactor(wb, c2)
        residual = residual.cpu().numpy()
        # Dual feasibility of the shared basis per scenario, checked on the
        # host in f64 (the f32 reduced costs carry ~eps |pi| noise); c is
        # per LP in the general lowering, so every distinct (A, c) is checked.
        nonbasic = cand.cpu().numpy() & ~wb.in_basis.cpu().numpy()
        c2_np = c2.cpu().numpy()
        dual_ok = True
        dmin_all = 0.0
        for k in range(Bsz):
            if k > 0 and problems[k].A is problems[0].A and np.array_equal(
                c2_np[k], c2_np[0]
            ):
                continue  # identical LP data: same verdict as LP 0
            ok_k, dmin_k, _ = warm_dual_feasible(
                problems[k].A, c2_np[k], warm_full, nonbasic[k], cfg.opt_tol
            )
            dmin_all = min(dmin_all, dmin_k)
            if not ok_k:
                dual_ok = False
                break
        if not (np.isfinite(residual).all() and (residual < 1e-4).all() and dual_ok):
            if _os.environ.get("RELP_TPU_BATCH_DEBUG", ""):
                print(
                    "  batch-debug warm disengaged: "
                    f"residual_max={float(np.nanmax(residual)):.3e} "
                    f"dmin_min={dmin_all:.3e} (opt_tol={cfg.opt_tol:g})",
                    flush=True,
                )
            return batch, None
        for _ in range(max_chunks):
            wb = run_step(
                batched_dual_run_chunk, wb,
                dict(A_scan=A_scan, A_full=A, c=c2, candidate_mask=cand),
                graphed=graphed,
                chunk=cfg.chunk_size,
                opt_tol=cfg.opt_tol,
                pivot_tol=cfg.pivot_tol,
                feas_tol=cfg.feas_tol,
                noisy_scan=noisy_backend,
            )
            if not (wb.status.cpu().numpy() == RUNNING).any():
                break
            wb, res = refactor(wb, c2)
            res = res.cpu().numpy()
            bad = ~np.isfinite(res) | (res > 1e-4)
            if bad.any():
                st = wb.status.cpu().numpy()
                wb = with_status(wb, np.where(bad & (st == RUNNING), SINGULAR, st))
        return wb, wb.iteration.cpu().numpy().astype(np.int64)

    t0 = time.perf_counter()
    dual_iters = np.zeros(len(problems), dtype=np.int64)
    warm_engaged = False
    if warm_start_basis is not None and cfg.dual_restart and mesh is None:
        batch_or_cold, warm_dual_iters = try_warm_dual(batch)
        if warm_dual_iters is not None:
            batch = batch_or_cold
            dual_iters = warm_dual_iters
            warm_engaged = True

    if warm_engaged:
        # Both phases skipped.  Dual-OPTIMAL LPs re-enter the primal loop,
        # which re-verifies optimality; dual-INFEASIBLE / SINGULAR /
        # budget-exhausted LPs stay frozen and fall back per LP below.
        phase1_iters = np.zeros(len(problems), dtype=np.int64)
        feasible = np.ones(len(problems), dtype=bool)
        status = batch.status.cpu().numpy()
        status = np.where(status == OPTIMAL, RUNNING, status)
        batch, _ = refactor(batch, c2)
        batch = with_status(batch, status)
    else:
        # Phase 1 for all (LPs with complete slack bases end at once at zero).
        batch = run_phase(batch, c1, stop_at_zero=True)
        phase1_iters = batch.iteration.cpu().numpy().astype(np.int64)

        # Phase transition: real costs, reset status for feasible LPs.
        feasible = batch.obj.cpu().numpy() <= cfg.phase1_tol
        batch, _ = refactor(batch, c2)
        status = np.where(feasible, RUNNING, batch.status.cpu().numpy())
        batch = with_status(batch, status)

    # Phase 2 + full-precision polish.  After an engaged warm restart the
    # phase is a near-optimal re-verification: it runs on the batched torch
    # path even when the kernels are enabled, as the JAX package rules.
    batch = run_phase(
        batch, c2, stop_at_zero=False, mega=use_megakernel and not warm_engaged,
    )
    if mixed:
        status = batch.status.cpu().numpy()
        polish = np.where(status == OPTIMAL, RUNNING, status)
        batch = with_status(batch, polish)
        batch, _ = refactor(batch, c2)
        batch = run_step(
            batched_run_chunk, batch, dict(A_scan=A, A_full=A, c=c2, candidate_mask=cand),
            graphed=graphed, shard=shard, **kwargs,
        )

    # Final from-scratch refactorization: extraction never trusts a carried
    # inverse; the residual and the basis-exact xB gate send bad LPs to the
    # single-LP fallback.
    batch, final_residual = refactor(batch, c2)
    final_residual = final_residual.cpu().numpy()
    if graphed:  # the steps that read a stacked tableau in place go with it
        _steps(shard).release(A, A_scan)

    wall = time.perf_counter() - t0

    # --- extraction ---
    results: List[OptimizationResult] = []
    status = batch.status.cpu().numpy()
    basis_all = batch.basis.cpu().numpy()
    xB_all = batch.xB.cpu().numpy()
    obj_all = batch.obj.cpu().numpy()
    c2_np = c2_host[lo:hi]  # the full width, for the host rescue
    iters = batch.iteration.cpu().numpy()
    n_fallback = 0
    n_rescued = 0
    _A64_cache = {}
    _debug_gates = _os.environ.get("RELP_TPU_BATCH_DEBUG", "")

    def _host_f64_rescue(k, problem):
        """Basis-exact xB/obj in f64 on the host (one LU solve) for an LP
        whose f32 refactorization failed the gates: an ill-conditioned but
        correct basis passes them in f64, a bad one still fails."""
        key = id(problem.A)
        A64 = _A64_cache.get(key)
        if A64 is None:
            A64 = np.asarray(problem.A, dtype=np.float64)
            _A64_cache[key] = A64
        B64 = A64[:, basis_all[k]]
        b64 = np.asarray(problem.b, dtype=np.float64)
        try:
            xB64 = np.linalg.solve(B64, b64)
        except np.linalg.LinAlgError:
            return None
        if not np.all(np.isfinite(xB64)):
            return None
        obj64 = float(np.asarray(c2_np[k], np.float64)[basis_all[k]] @ xB64)
        return xB64, obj64

    for k, (provider, problem) in enumerate(zip(my_providers, problems)):
        stats = SolveStats(
            iterations=int(iters[k]),
            phase1_iterations=int(phase1_iters[k]),
            dual_iterations=int(dual_iters[k]),
            wall_time_s=wall,
        )
        ok = feasible[k] and status[k] == OPTIMAL
        xB_row = xB_all[k]
        obj_k = float(obj_all[k])

        def _gates(xB_row, residual_ok):
            # Numerics: finite, small refactorization residual, primal
            # feasible basis-exact xB.  Artificials: zero-level ones may stay
            # basic; a clearly nonzero one means the batch solve went wrong.
            numerics = ok and (
                residual_ok
                and float(xB_row[: problem.m_real].min()) >= -cfg.feas_tol
            )
            artificial = ok and all(
                int(basis_all[k, i]) < problem.art_offset
                or abs(xB_row[i]) <= 1e-6
                for i in range(problem.m_real)
            )
            return numerics, artificial

        numerics_ok, artificial_ok = _gates(
            xB_row,
            bool(np.isfinite(final_residual[k]) and final_residual[k] <= 1e-4),
        )
        rescued = False
        if ok and not (numerics_ok and artificial_ok):
            rescue = _host_f64_rescue(k, problem)
            if rescue is not None:
                xB64, obj64 = rescue
                n_ok, a_ok = _gates(xB64, np.isfinite(obj64))
                if n_ok and a_ok:
                    xB_row, obj_k = xB64, obj64
                    numerics_ok = artificial_ok = True
                    rescued = True
                    n_rescued += 1
        if _debug_gates:
            print(
                f"  batch-debug LP{k}: status={int(status[k])} "
                f"feasible={bool(feasible[k])} iters={int(iters[k])} "
                f"residual={float(final_residual[k]):.3e} "
                f"xBmin={float(xB_row[: problem.m_real].min()):.3e} "
                f"artificial_ok={artificial_ok} rescued={rescued}",
                flush=True,
            )
        if not ok or not numerics_ok or not artificial_ok:
            results.append(_single_lp_fallback(provider, cfg, certify))
            n_fallback += 1
            continue

        structural_basis = [int(basis_all[k, i]) for i in range(problem.m_real)]
        entries = []
        for i in range(problem.m_real):
            j = structural_basis[i]
            if j < problem.n_real and abs(xB_row[i]) > cfg.zero_tol:
                value = xB_row[i]
                if problem.col_scale is not None:
                    value *= problem.col_scale[j]
                entries.append((j, value))
        result = OptimizationResult(
            status=SolveStatus.FINITE_OPTIMUM,
            objective=obj_k,
            basis=structural_basis,
            stats=stats,
        )
        result.float_entries = entries  # type: ignore[attr-defined]
        if certify:
            with trace.timed("certify") as clock:
                certify_and_repair(
                    result, provider, structural_basis, cfg,
                    art_offset=problem.art_offset,
                )
            stats.certify_time_s += clock.seconds
            if not result.stats.certified:
                # Numerically troubled LPs go to the single-LP driver (with
                # its f64 escalation) rather than ship uncertified.
                results.append(_single_lp_fallback(provider, cfg, certify))
                n_fallback += 1
                continue
        else:
            result.bfs = SparseVector(
                [(j, Fraction(float(v))) for j, v in entries], problem.n_real
            )
        results.append(result)
    if n_fallback:
        _log.info(
            "batch solve: %d/%d LPs fell back to the single-LP driver",
            n_fallback, len(my_providers),
        )
    if mesh is not None and hi - lo < len(providers):
        # Every rank returns the whole list, in scenario order.
        import torch.distributed as dist

        group = mesh.get_group("batch")
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, results, group=group)
        results = [r for part in parts for r in part]
    return results


def _single_lp_fallback(
    provider: MatrixProvider, cfg: SolverConfig, certify: bool
) -> OptimizationResult:
    """Solve one LP through the port's single-LP driver (rank repair, Bland,
    f64 escalation); used for batch members that failed the lockstep path.
    Its chunks on a card replay from the process-wide cache of chunks, so a
    wave's fallbacks of one shape capture each kind of chunk once."""
    from relp_tpu_torch.simplex.driver import solve_relaxation

    # device_refactor is a batched-chunk notion; dropping it re-clamps
    # chunk_size <= refactor_period in __post_init__.
    single_cfg = dataclasses.replace(cfg, certify=certify, device_refactor=False)
    result = solve_relaxation(provider, single_cfg)
    result.stats.batch_fallback = True
    return result
