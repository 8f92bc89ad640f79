#!/usr/bin/env python3
"""Smoke run of relp_tpu_torch on one CUDA card (an H100 for the numbers in
PERF.md): builds the hand-written kernels from the checkout, holds each
against its plain PyTorch version, and drives the single-LP main path
(file -> two-phase steepest-edge simplex -> exact certificate) and the
scenario-batch path (solve_batch -> batched-pivot kernels -> a certificate
per LP) at real sizes.

    python3 chip_smoke.py

Takes no arguments and needs no network.  Phases, one line each (or more):

  1. device        the card, its power limit, torch and CUDA versions, and
                   the float32 matmul precision (TF32 must be off);
  2. build         nvcc of every relp_tpu_torch/csrc/*.cu, in parallel, into
                   one library (ptxas summary; dynamic shared memory of the
                   batched-pivot kernels at the families' shapes);
  3. kernel        fused_price_scan against fused_price_scan_reference at
                   several shapes and at the main path's, f32 / f64 / bf16,
                   with CUDA-event times, and torch.matmul(P, A) (TF32 off,
                   the product without the d/gamma epilogue) as yardstick;
  4. probe         the precision probe (relp_tpu_torch.tools.
                   probe_dot_precision): single-pass TF32 above 1e-6
                   relative error, 3xTF32 and the outer product within it;
  5. batch/kernel  both batched-pivot kernels against
                   batched_pivot_chunk_reference from the same state, one
                   25-pivot chunk with and without stop_at_zero, at the JAX
                   tests' toy shapes and the two family shapes from the
                   phase-1 start, and without it from the families' phase-2
                   start: identical bases, statuses and iteration counts,
                   the float state within tolerance, bitwise repeatable, and
                   at the family shapes the same bits on the one shared
                   tableau (batch stride 0) as on B stacked copies;
                   CUDA-event times;
  6. main/small    `solve --json tests/data/knap6.mps` through the CLI
                   (exact -30, certified) and a max-flow network through
                   solve_relaxation (flow 4);
  7. main/real     the generated LP of relp_tpu_torch.testing at m=384,
                   n=1536 through solve_general_form: certified, the pinned
                   exact-objective digest, and HiGHS agreement to 1e-6;
  8. chunk         marginal per-pivot time of run_chunk at the 1024 x 4096
                   bench problem, kernel path and plain path;
  9. batch/resident, batch/blocked
                   solve_batch (default config) on the two scenario
                   families of relp_tpu_torch.testing (256 x 128x384 and
                   128 x 512x1408 lowered): every LP certified, the pinned
                   digest of the exact objectives, HiGHS on three scenarios,
                   the kernel of each family launched, peak device memory;
 10. batch/memory  peak device memory of each family's solve_batch (no
                   certification) with the one shared tableau and with B
                   stacked copies of it (the first port's layout): the same
                   results, the copies' bytes saved;
 11. batch/warm    the resident family's LP with +-40% rhs wobbles,
                   warm-started from the base optimum: every scenario needs
                   dual pivots; its pinned digest, no phase 1, the dual and
                   the phase-2 chunks on the batched torch path and no
                   kernel launch;
 12. batch/chunk   marginal pivots/s of the whole batch from the phase-2
                   start, kernel path and plain path, at both family shapes,
                   over a window in which every LP pivots.

Then a JSON line describing each kernel (six: the scan, the two
batched-pivot kernels and the probe's three) with its time, its plain
version's, its bound (the larger of its bytes at 3.35 TB/s and its
operations at the H100's peak for their type) and the library yardstick,
and as the last line {"ok": true, "device": {...}}.  Any failure raises: the exit code is then
non-zero and no result line is printed.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


# Published peaks of one H100 SXM (700 W; NVIDIA's data sheet, dense):
# device memory and the rates of the operations the kernels do (f32 and
# f64 on the vector units, TF32 on the tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
TF32_FLOPS = 495e12


def _bound(bytes_moved: float, flops: float, peak: float = F32_FLOPS):
    """(bound_ms, bound_by): the least time for the bytes at the memory
    rate and for the operations at ``peak``, whichever is larger."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _line(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_device(torch):
    from relp_tpu_torch.config import SolverConfig, torch_device

    device = torch_device(SolverConfig())
    _check(torch.get_float32_matmul_precision() == "highest", "matmul precision")
    _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _line(
        "device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, matmul_precision="highest", tf32=False,
    )
    return device


def phase_build():
    from relp_tpu_torch.ops import _build, batch_pivot, price_scan

    t0 = time.perf_counter()
    price_scan.build()
    batch_pivot._lib()
    ptxas = [
        " ".join(line.split())
        for line in _build.BUILD_LOG.splitlines()
        if "entry function" in line or "registers" in line or "spill" in line
    ]
    _line(
        "build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{_build.BUILD_SECONDS:.2f}",
        sources=",".join(p.name for p in _build.sources()),
    )
    for line in ptxas:
        print(f"  ptxas: {line}", flush=True)
    # The batched-pivot kernels take their shared memory dynamically, so
    # ptxas does not see it: the bytes per block at the families' shapes.
    for name, (M, N) in _family_shapes().items():
        resident = name == "resident"
        _line(
            "build", kernel=f"batch_pivot_kernel<{str(resident).lower()}>",
            shape=f"{M}x{N}",
            dynamic_smem_bytes=batch_pivot.smem_bytes(M, N, resident=resident),
            inverse_rows_in_smem=M if resident else batch_pivot.blocked_rows(M, N),
            limit=batch_pivot.SMEM_LIMIT,
        )


def _replay_ms(torch, body, replays: int = 10) -> float:
    """Device milliseconds of one run of ``body``, captured in a CUDA graph
    and replayed between CUDA events (no host launch overhead inside)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # warm up (and allocate) outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / replays


def _graph_ms(torch, fn, calls: int = 20, flush=None) -> float:
    """Device milliseconds per call of ``fn``.  With ``flush`` (a buffer
    larger than L2), each call follows a write of it, so the call finds its
    inputs in device memory, and the time of the writes alone is taken off."""

    def flushes():
        for _ in range(calls):
            flush.zero_()

    def body():
        for _ in range(calls):
            if flush is not None:
                flush.zero_()
            fn()

    ms = _replay_ms(torch, body) / calls
    if flush is not None:
        ms -= _replay_ms(torch, flushes) / calls
    return ms


def main_path_shape():
    """(M, N) of the lowered real-size generated LP: the shape at which the
    main path calls the scan kernel."""
    from relp_tpu_torch.linalg.device import pad_to_multiple
    from relp_tpu_torch.testing import REAL_SIZE, generated_lp

    gf = generated_lp(**REAL_SIZE)
    gf.presolve()
    md = gf.derive_matrix_data(gf.standardize())
    M = pad_to_multiple(md.nr_rows(), 128)
    return M, pad_to_multiple(md.nr_columns() + M, 128)


def phase_kernel(torch, np, device):
    from relp_tpu_torch.ops import price_scan

    main_shape = main_path_shape()
    # (M, N, dtype, tolerance factor): |err| <= tol * (1 + max|plain|).
    # f32 and f64 differ from the plain version only by summation order;
    # bf16 rounds S and every output to 8 bits in both, at other places.
    cases = [
        (8, 128, torch.float32, 1e-5),
        (96, 1280, torch.float32, 1e-5),
        (100, 1000, torch.float32, 1e-5),
        (1024, 5120, torch.float32, 1e-5),
        (*main_shape, torch.float32, 1e-5),
        (384, 1920, torch.float64, 1e-12),
        (*main_shape, torch.float64, 1e-12),
        (96, 1280, torch.bfloat16, 5e-2),
        (1024, 5120, torch.bfloat16, 5e-2),
    ]
    errors = {}
    times = {}
    # Writing 128 MB evicts any tableau from the 50 MB L2 between calls.
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=device)
    for M, N, dtype, tol in cases:
        rng = np.random.default_rng(M * 7919 + N)
        as_t = lambda x: torch.as_tensor(x, device=device).to(dtype)  # noqa: E731
        P = as_t(rng.standard_normal((3, M)))
        A = as_t(rng.standard_normal((M, N)))
        c = as_t(rng.standard_normal(N))
        g = as_t(1.0 + np.abs(rng.standard_normal(N)))
        gq = as_t(1.0 + abs(float(rng.standard_normal())) * 5)
        d_k, g_k = price_scan.fused_price_scan(P, A, c, g, gq)
        torch.cuda.synchronize()
        d_p, g_p = price_scan.fused_price_scan_reference(P, A, c, g, gq)
        torch.cuda.synchronize()
        errs = []
        for name, kern, plain in (("d", d_k, d_p), ("gamma", g_k, g_p)):
            kern64, plain64 = kern.double(), plain.double()
            _check(bool(torch.isfinite(kern64).all()), f"non-finite {name}")
            err = float((kern64 - plain64).abs().max())
            scale = float(plain64.abs().max())
            _check(
                err <= tol * (1.0 + scale),
                f"{name} at {M}x{N} {dtype}: |err| {err:.3e} > "
                f"{tol:g} * (1 + {scale:.3e})",
            )
            errors[(M, N, dtype)] = max(errors.get((M, N, dtype), 0.0), err)
            errs.append(f"{name}:{err / (1.0 + scale):.3e}")
        kern = lambda: price_scan.fused_price_scan(P, A, c, g, gq)  # noqa: E731
        plain = lambda: price_scan.fused_price_scan_reference(P, A, c, g, gq)  # noqa: E731
        library = lambda: torch.matmul(P, A)  # noqa: E731  (no epilogue)
        kern_ms, plain_ms = _graph_ms(torch, kern), _graph_ms(torch, plain)
        library_ms = _graph_ms(torch, library)
        cold = (_graph_ms(torch, kern, flush=flush), _graph_ms(torch, plain, flush=flush))
        size = A.element_size()
        # Reads A, P, c and gamma once, writes d and gamma: 6 M N operations.
        bound_ms, bound_by = _bound((M * N + 3 * M + 4 * N) * size, 6.0 * M * N,
                                    F64_FLOPS if dtype == torch.float64 else F32_FLOPS)
        times[(M, N, dtype)] = (kern_ms, plain_ms, library_ms, bound_ms, bound_by)
        tableau_gb = M * N * A.element_size() / 1e9
        _line(
            "kernel", shape=f"{M}x{N}", dtype=str(dtype).replace("torch.", ""),
            rel_err=",".join(errs), tol=f"{tol:g}*(1+scale)",
            kernel_ms=f"{kern_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            matmul_ms=f"{library_ms:.5f}", bound_ms=f"{bound_ms:.5f}",
            bound_by=bound_by, bound_share=f"{bound_ms / kern_ms:.3f}",
            kernel_cold_ms=f"{cold[0]:.5f}", plain_cold_ms=f"{cold[1]:.5f}",
            kernel_GBps=f"{tableau_gb / (kern_ms * 1e-3):.1f}",
            kernel_cold_GBps=f"{tableau_gb / (cold[0] * 1e-3):.1f}",
        )
    return main_shape, errors, times


def phase_probe(torch, device):
    """The precision probe's main path (relp_tpu_torch.tools.
    probe_dot_precision.run) with its launch counts from 0, its checks,
    then each kernel's time beside its plain version (numpy f64 on the
    host), its bound and a library call: torch.matmul with TF32 allowed
    (tf32), torch.matmul in full f32 (tf32x3: the same product, by another
    method), torch.outer (outer)."""
    from relp_tpu_torch.tools import probe_dot_precision as probe

    for kind in probe.KINDS:
        probe.LAUNCHES[kind] = 0
    rel = probe.run(device)
    launches = dict(probe.LAUNCHES)
    _check(1e-6 < rel["tf32"] < 1e-2, f"probe tf32 error {rel['tf32']:.3e}")
    _check(rel["tf32x3"] <= 1e-6 and rel["outer"] <= 1e-6,
           f"probe errors {rel}")
    a, b = probe.inputs(device)
    M = a.shape[0]
    library = {
        "tf32": lambda: torch.matmul(a, b),
        "tf32x3": lambda: torch.matmul(a, b),
        "outer": lambda: torch.outer(a[:, 0], b[0, :]),
    }
    bounds = {
        "tf32": _bound(3 * M * M * 4, 2.0 * M ** 3, TF32_FLOPS),
        "tf32x3": _bound(3 * M * M * 4, 6.0 * M ** 3, TF32_FLOPS),
        "outer": _bound((2 * M + M * M) * 4, 1.0 * M * M, F32_FLOPS),
    }
    out = {}
    for kind in probe.KINDS:
        exact = probe.probe_dot_reference(kind, a, b)
        err = float((probe.probe_dot(kind, a, b).double().cpu() - exact).abs().max())
        ms = _graph_ms(torch, lambda: probe.probe_dot(kind, a, b))
        t0 = time.perf_counter()
        for _ in range(5):
            probe.probe_dot_reference(kind, a, b)
        plain_ms = (time.perf_counter() - t0) / 5 * 1e3
        torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
        try:
            library_ms = _graph_ms(torch, library[kind])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out[kind] = dict(launches=launches[kind], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bounds[kind][0],
                         bound_by=bounds[kind][1], library_ms=library_ms)
        _line("probe", kind=kind, shape=f"{M}x{M}", rel_err=f"{rel[kind]:.3e}",
              launches=launches[kind], kernel_ms=f"{ms:.5f}",
              plain_host_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.5f}",
              bound_ms=f"{bounds[kind][0]:.5f}", bound_by=bounds[kind][1])
    return out


def phase_main_small(torch):
    from relp_tpu_torch.__main__ import main as cli
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.simplex import SolveStatus, solve_relaxation

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(["solve", "--json", os.path.join(HERE, "tests", "data", "knap6.mps")])
    payload = json.loads(out.getvalue())
    _check(rc == 0, f"knap6 rc={rc}")
    _check(payload["status"] == "finite_optimum", f"knap6 {payload}")
    _check(payload["objective"] == "-30" and payload["certified"] is True, f"knap6 {payload}")
    _line(
        "main/small", problem="knap6", status=payload["status"],
        objective=payload["objective"], certified=payload["certified"],
        pivots=payload["iterations"],
    )

    # The network of examples/max_flow.py (adjacency[to][from] = capacity);
    # the JAX package's example reports max flow 4 on it.
    from fractions import Fraction as F

    from relp_tpu_torch.data.network import MaxFlowPrimal

    adjacency = [
        [F(0), F(0), F(0), F(0)],
        [F(3), F(0), F(0), F(0)],
        [F(2), F(1), F(0), F(0)],
        [F(0), F(2), F(2), F(0)],
    ]
    problem = MaxFlowPrimal(adjacency, s=0, t=3)
    result = solve_relaxation(problem, SolverConfig(pad_to=8))
    flow = problem.flow_value(problem.reconstruct_solution(result.bfs))
    _check(result.status is SolveStatus.FINITE_OPTIMUM, f"max flow {result.status}")
    _check(flow == 4 and result.stats.certified, f"max flow {flow}")
    _line("main/small", problem="max_flow", flow=flow, certified=result.stats.certified)


def _highs_objective(np):
    import scipy.optimize

    from relp_tpu_torch.testing import REAL_SIZE, generated_lp_data

    A, b, c, kinds = generated_lp_data(**REAL_SIZE)
    kinds = np.asarray(kinds)
    le, ge, eq = kinds == "<=", kinds == ">=", kinds == "=="
    res = scipy.optimize.linprog(
        c.astype(float),
        A_ub=np.vstack([A[le], -A[ge]]).astype(float),
        b_ub=np.concatenate([b[le], -b[ge]]).astype(float),
        A_eq=A[eq].astype(float), b_eq=b[eq].astype(float),
        bounds=(0, 10), method="highs",
    )
    _check(res.status == 0, f"HiGHS status {res.status}")
    return float(res.fun)


def phase_main_real(torch, np):
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.ops import price_scan
    from relp_tpu_torch.simplex import SolveStatus, solve_general_form
    from relp_tpu_torch.testing import (
        REAL_SIZE,
        REAL_SIZE_OBJECTIVE_SHA256,
        generated_lp,
    )

    gf = generated_lp(**REAL_SIZE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, solution = solve_general_form(gf, SolverConfig())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(result.status is SolveStatus.FINITE_OPTIMUM, f"status {result.status}")
    _check(result.stats.certified, "not certified")
    digest = hashlib.sha256(str(solution.objective_value).encode()).hexdigest()
    _check(digest == REAL_SIZE_OBJECTIVE_SHA256, f"objective digest {digest}")
    objective = float(solution.objective_value)
    highs = _highs_objective(np)
    rel = abs(objective - highs) / max(1.0, abs(highs))
    _check(rel <= 1e-6, f"HiGHS {highs} vs {objective}")
    _line(
        "main/real", m=REAL_SIZE["m"], n=REAL_SIZE["n"], seed=REAL_SIZE["seed"],
        status=result.status.value, certified=result.stats.certified,
        pivots=result.stats.iterations, phase1_pivots=result.stats.phase1_iterations,
        escalations=",".join(result.stats.escalations) or "none",
        refactorizations=result.stats.refactorizations, chunks=result.stats.chunks,
        wall_s=f"{wall:.3f}", solve_wall_s=f"{result.stats.wall_time_s:.3f}",
        certify_s=f"{result.stats.certify_time_s:.3f}",
        objective=f"{objective:.12f}", digest_ok=True, highs_rel_diff=f"{rel:.2e}",
        price_scan_launches=price_scan.LAUNCHES,
    )


def phase_chunk_loop(torch, np, device, times):
    from relp_tpu_torch.ops import price_scan
    from relp_tpu_torch.simplex import kernels
    from relp_tpu_torch.simplex.state import RUNNING, state_from_numpy
    from relp_tpu_torch.testing import synthetic_problem

    A, b, c1, _c2, cand, basis = synthetic_problem(
        m=1024, n=4096, pad=128, seed=7, dtype=np.float32
    )
    M, N = A.shape
    in_basis = np.zeros(N, dtype=bool)
    in_basis[basis] = True
    cB = c1[basis]
    zero = np.int32(0)
    state0 = state_from_numpy(
        dict(
            Binv=np.eye(M, dtype=np.float32), basis=basis, xB=b, pi=cB,
            obj=np.float32(cB @ b), in_basis=in_basis,
            gamma=np.ones(N, dtype=np.float32), iteration=zero,
            status=np.int32(RUNNING), degen_count=zero, inner=zero,
            price_start=zero, d=(c1 - cB @ A).astype(np.float32),
        ),
        device,
    )
    A_d = torch.as_tensor(A, device=device)
    c_d = torch.as_tensor(c1, device=device)
    cand_d = torch.as_tensor(cand, device=device)

    def run(chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = kernels.run_chunk(
            state0, A_d, A_d, c_d, cand_d, pricing=kernels.PRICE_STEEPEST,
            chunk=chunk, opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7,
        )
        pivots = int(out.iteration)  # forces the sync inside the timed region
        return time.perf_counter() - t0, pivots

    @contextlib.contextmanager
    def scan(path):
        """The kernel path, or the plain version swapped in on the card."""
        kept = kernels.fused_price_scan
        if path == "plain":
            kernels.fused_price_scan = price_scan.fused_price_scan_reference
        try:
            yield
        finally:
            kernels.fused_price_scan = kept

    chunks = (10, 300)
    for path in ("kernel", "plain"):  # warm up outside the timed region
        with scan(path):
            for chunk in chunks:
                run(chunk)
    estimates = {"kernel": [], "plain": []}
    pivots = {}
    for rep in range(8):
        order = ("kernel", "plain") if rep % 2 == 0 else ("plain", "kernel")
        for path in order:
            with scan(path):
                t_small, i_small = run(chunks[0])
                t_big, i_big = run(chunks[1])
            pivots[path] = (i_small, i_big)
            _check(i_big > i_small, f"{path}: no pivots {i_small} {i_big}")
            estimates[path].append((t_big - t_small) / (i_big - i_small))
    per_pivot = {p: float(np.median(v)) for p, v in estimates.items()}
    quartiles = {
        p: "/".join(f"{q * 1e3:.4f}" for q in np.percentile(v, [25, 75]))
        for p, v in estimates.items()
    }
    kern_ms, plain_ms = times[(1024, 5120, torch.float32)][:2]
    busy_ms, launches, top = _device_busy(torch, lambda: run(60), 60)
    idle = 1.0 - busy_ms / (per_pivot["kernel"] * 1e3) if busy_ms else None
    _line(
        "chunk", shape=f"{M}x{N}", dtype="float32", pricing="steepest",
        method="median of 8 interleaved (300-10)-pivot differences",
        pivots=pivots["kernel"][1],
        kernel_path_ms_per_pivot=f"{per_pivot['kernel'] * 1e3:.4f}",
        plain_path_ms_per_pivot=f"{per_pivot['plain'] * 1e3:.4f}",
        kernel_path_q1_q3=quartiles["kernel"], plain_path_q1_q3=quartiles["plain"],
        scan_kernel_ms=f"{kern_ms:.5f}", scan_plain_ms=f"{plain_ms:.5f}",
    )
    _line(
        "chunk/profile", pivots=60,
        device_busy_ms_per_pivot=f"{busy_ms:.4f}" if busy_ms else "not measured",
        device_idle_share=f"{idle:.3f}" if idle is not None else "not measured",
        kernel_launches_per_pivot=f"{launches / 60:.1f}",
        top_kernels=";".join(f"{name}:{ms:.4f}ms" for name, ms in top),
    )


def _device_busy(torch, fn, pivots: int):
    """torch.profiler over ``fn``: device milliseconds per pivot summed over
    CUDA kernels, kernel launches, and the five costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0
        )

    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / pivots
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:5]
    return busy_ms, launches, [(e.key[:40], device_us(e) / 1e3 / pivots) for e in top]


_SHAPES = {}


def _lowered_shape(m, n, seed):
    """(M, N) of a scenario family's lowered tableau (pad_to=128)."""
    from relp_tpu_torch.linalg.device import pad_to_multiple
    from relp_tpu_torch.testing import scenario_base

    if (m, n, seed) not in _SHAPES:
        gf, counts = scenario_base(m, n, seed)
        md = gf.derive_matrix_data(counts)
        M = pad_to_multiple(md.nr_rows(), 128)
        _SHAPES[(m, n, seed)] = (M, pad_to_multiple(md.nr_columns() + M, 128))
    return _SHAPES[(m, n, seed)]


def _family_shapes():
    """(M, N) of each cold scenario family's lowered tableau."""
    from relp_tpu_torch.testing import FAMILIES

    return {name: _lowered_shape(f["m"], f["n"], f["seed"])
            for name, f in FAMILIES.items()}


def _batch_config():
    from relp_tpu_torch.config import SolverConfig

    return SolverConfig(pad_to=128, chunk_size=150, refactor_period=150)


def _family_start(torch, name, count=None):
    """A scenario family at its phase-1 start on the card: (providers,
    problems, A, b, c1, c2, cand, batch) with fresh steepest-edge weights,
    as solve_batch starts phase 1."""
    from relp_tpu_torch.parallel.batch import _v_gamma
    from relp_tpu_torch.parallel.batch_driver import lower_batch
    from relp_tpu_torch.testing import FAMILIES, scenario_family

    fam = dict(FAMILIES[name])
    if count is not None:
        fam["count"] = count
    providers = scenario_family(**fam)
    problems, A, b, c1, c2, cand, batch = lower_batch(
        providers, _batch_config(), torch.device("cuda"), shared_structure=True
    )
    batch = batch._replace(gamma=_v_gamma(batch.Binv, A, batch.in_basis))
    return providers, problems, A, b, c1, c2, cand, batch


_PHASE2 = {}


def _family_phase2_start(torch, name):
    """A scenario family at its phase-2 start on the card: (A, c2, cand,
    batch).  Phase 1 runs to its end through the family's kernel, then every
    basis is refactorized on the real costs with fresh steepest-edge
    weights, as solve_batch switches phases (without its chunk-exit
    refreshes).  Made once per family."""
    if name not in _PHASE2:
        from relp_tpu_torch.parallel.batch import (
            _v_gamma,
            _v_refactor,
            megakernel_run_chunk,
        )
        from relp_tpu_torch.simplex.state import RUNNING

        cfg = _batch_config()
        tol = dict(opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
                   degen_tol=cfg.feas_tol)
        _p, _pr, A, b, c1, c2, cand, st = _family_start(torch, name)
        for _ in range(20):
            st = megakernel_run_chunk(st, A, c1, cand, chunk=cfg.chunk_size,
                                      stop_at_zero=True, **tol)
            if not bool(((st.status == RUNNING) & (st.obj > 1e-9)).any()):
                break
        obj1 = _v_refactor(A, b, c1, st.basis, newton_steps=1)[3]
        _check(bool((obj1 <= cfg.phase1_tol).all()),
               f"{name}: phase 1 left an LP infeasible")
        Binv, xB, pi, obj, _res = _v_refactor(A, b, c2, st.basis, newton_steps=1)
        xB = torch.where(xB > -cfg.feas_tol, torch.clamp_min(xB, 0.0), xB)
        st = st._replace(
            Binv=Binv, xB=xB, pi=pi, obj=obj,
            status=torch.full_like(st.status, RUNNING),
            gamma=_v_gamma(Binv, A, st.in_basis),
        )
        _PHASE2[name] = (A, c2, cand, st)
    return _PHASE2[name]


def _toy_start(torch, np, B, m, n):
    """The JAX megakernel tests' toy batch (tests/test_pallas_batch.py
    _toy_batch): B synthetic LPs, seeds 0..B-1, at their artificial start."""
    from relp_tpu_torch.parallel.batch import make_batch_state
    from relp_tpu_torch.simplex.state import RUNNING, state_from_numpy
    from relp_tpu_torch.testing import synthetic_problem

    dev = torch.device("cuda")
    states, As, cs, cands = [], [], [], []
    for s in range(B):
        A, b, c1, _c2, cand, basis = synthetic_problem(
            m=m, n=n, pad=32, seed=s, dtype=np.float32
        )
        M, N = A.shape
        in_basis = np.zeros(N, dtype=bool)
        in_basis[basis] = True
        cB = c1[basis]
        zero = np.int32(0)
        states.append(state_from_numpy(dict(
            Binv=np.eye(M, dtype=np.float32), basis=basis, xB=b, pi=cB,
            obj=np.float32(cB @ b), in_basis=in_basis,
            gamma=np.ones(N, dtype=np.float32), iteration=zero,
            status=np.int32(RUNNING), degen_count=zero, inner=zero,
            price_start=zero, d=(c1 - cB @ A).astype(np.float32),
        ), dev))
        As.append(A)
        cs.append(c1)
        cands.append(cand)
    as_t = lambda x: torch.as_tensor(np.stack(x), device=dev)  # noqa: E731
    return as_t(As), as_t(cs), as_t(cands), make_batch_state(states)


def _events_ms(torch, fn, calls: int = 3) -> float:
    """Device milliseconds per call of ``fn`` between CUDA events (after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


# Tolerances of tests/test_pallas_batch.py for the kernels against the plain
# batched path, here relative to 1 + max|plain| (the families' values reach
# 1e3, the toys' about 10): xB 1e-4, pi 1e-3, Binv 1e-3, gamma 1e-2.
_BATCH_TOL = {"xB": 1e-4, "pi": 1e-3, "Binv": 1e-3, "gamma": 1e-2}
_OUT_FIELDS = ("Binv", "xB", "pi", "basis", "in_basis", "gamma", "status",
               "iteration", "degen")


def phase_batch_kernel(torch, np):
    """Each batched-pivot kernel against batched_pivot_chunk_reference, from
    the same state, one 25-pivot chunk, with and without stop_at_zero."""
    from relp_tpu_torch.ops import batch_pivot

    cfg = _batch_config()
    fam_tol = dict(opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol,
                   degen_tol=cfg.feas_tol)
    toy_tol = dict(opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7)
    both, no_stop = (True, False), (False,)
    cases = []
    for variant in ("resident", "blocked"):
        for (B, m, n) in ((3, 32, 64), (3, 48, 192)):
            cases.append((variant, f"toy{B}x{m}x{n}", lambda B=B, m=m, n=n:
                          _toy_start(torch, np, B, m, n), toy_tol, both))
        cases.append((variant, f"family:{variant}", lambda v=variant: (
            lambda s: (s[2], s[4], s[6], s[7]))(_family_start(torch, v)),
            fam_tol, both))
        # Phase 2 (real costs, most of a family's pivots): stop_at_zero
        # would freeze every LP whose objective is not positive.
        cases.append((variant, f"phase2:{variant}", lambda v=variant:
                      _family_phase2_start(torch, v), fam_tol, no_stop))
    errors, times = {}, {}
    for variant, label, make, tol, stops in cases:
        A, c, cand, st = make()
        kern = (batch_pivot.batched_pivot_chunk if variant == "resident"
                else batch_pivot.batched_pivot_chunk_blocked)
        args = (A, c, cand, st.Binv, st.xB, st.pi, st.basis, st.in_basis,
                st.gamma, st.status, st.iteration, st.degen_count)
        for stop_at_zero in stops:
            kw = dict(chunk=25, stop_at_zero=stop_at_zero, **tol)
            out_k = kern(*args, **kw)
            out_k2 = kern(*args, **kw)
            torch.cuda.synchronize()
            out_p = batch_pivot.batched_pivot_chunk_reference(*args, **kw)
            torch.cuda.synchronize()
            k, k2, p = (dict(zip(_OUT_FIELDS, o)) for o in (out_k, out_k2, out_p))
            for f in _OUT_FIELDS:
                _check(torch.equal(k[f], k2[f]), f"{label} {variant}: {f} differs "
                       "between two launches")
            for f in ("basis", "in_basis", "status", "iteration"):
                same = (k[f] == p[f]).reshape(k[f].shape[0], -1).all(dim=1)
                _check(bool(same.all()), f"{label} {variant} stop_at_zero="
                       f"{stop_at_zero}: {f} differs for LPs "
                       f"{torch.nonzero(~same).flatten().tolist()[:10]}")
            rel = {}
            for f, t in _BATCH_TOL.items():
                scale = 1.0 + float(p[f].abs().max())
                err = float((k[f].double() - p[f].double()).abs().max())
                rel[f] = err / scale
                _check(err <= t * scale, f"{label} {variant}: {f} |err| "
                       f"{err:.3e} > {t:g} * {scale:.3e}")
            # (largest absolute error, largest error relative to 1 + max|plain|)
            errors[(variant, label, stop_at_zero)] = (max(
                float((k[f].double() - p[f].double()).abs().max())
                for f in _BATCH_TOL
            ), max(rel.values()))
            shared = A.stride(0) == 0
            if shared:  # one tableau for the batch: the bits of B copies
                out_c = dict(zip(_OUT_FIELDS, kern(A.contiguous(), *args[1:], **kw)))
                torch.cuda.synchronize()
                for f in _OUT_FIELDS:
                    _check(torch.equal(k[f], out_c[f]), f"{label} {variant}: {f} "
                           "differs between one shared tableau and B copies")
            kern_ms = _events_ms(torch, lambda: kern(*args, **kw))
            plain_ms = _events_ms(
                torch, lambda: batch_pivot.batched_pivot_chunk_reference(*args, **kw)
            )
            pivots = k["iteration"] - st.iteration
            bound_ms, bound_by = _pivot_chunk_bound(A, int(pivots.sum()),
                                                    int((st.status == 0).sum()))
            times[(variant, label, stop_at_zero)] = (kern_ms, plain_ms, bound_ms,
                                                     bound_by)
            _line(
                "batch/kernel", variant=variant, case=label,
                shape="x".join(map(str, A.shape)), stop_at_zero=stop_at_zero,
                pivots=int(pivots.sum()), min_lp_pivots=int(pivots.min()),
                identical="basis,in_basis,status,iteration", repeat_bitwise=True,
                shared_tableau_bitwise=shared if shared else "n/a (B tableaus)",
                rel_err=",".join(f"{f}:{v:.2e}" for f, v in rel.items()),
                kernel_ms=f"{kern_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                bound_share=f"{bound_ms / kern_ms:.3f}",
            )
    return errors, times


def _pivot_chunk_bound(A, pivots: int, running: int):
    """(bound_ms, bound_by) of one batched-pivot chunk: the tableau (once,
    or once per LP when the batch stacks copies) and every LP's state in
    and out, against 6 M N + 6 M^2 operations per pivot taken (the stacked
    scan, FTRAN, v and the rank-1 update) and 2 M N per running LP (the
    chunk-entry reduced costs)."""
    B, M, N = A.shape
    tableaus = 1 if A.stride(0) == 0 else B
    state = B * (2 * M * M * 4 + 2 * 3 * M * 4 + N * 4 + N + 2 * N + 2 * N * 4)
    flops = pivots * (6.0 * M * N + 6.0 * M * M) + running * 2.0 * M * N
    return _bound(tableaus * M * N * 4 + state, flops)


def _highs_check(np, providers, results, picks):
    """HiGHS on the standard-form arrays of a few scenarios, against the
    certified exact objectives (relative 1e-6)."""
    import scipy.optimize

    worst = 0.0
    for k in picks:
        A, b, c = providers[k].to_arrays()
        res = scipy.optimize.linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                                     method="highs")
        _check(res.status == 0, f"HiGHS status {res.status} on scenario {k}")
        exact = float(results[k].exact_objective)
        rel = abs(exact - res.fun) / max(1.0, abs(res.fun))
        _check(rel <= 1e-6, f"scenario {k}: HiGHS {res.fun} vs {exact}")
        worst = max(worst, rel)
    return worst


def phase_batch_family(torch, np, label, fam, digest_want, warm_start_basis=None):
    """solve_batch on a scenario family through the entry point a user
    calls, every LP certified, the pinned digest of the exact objectives,
    HiGHS on a few scenarios."""
    from relp_tpu_torch.ops import batch_pivot
    from relp_tpu_torch.parallel import solve_batch
    from relp_tpu_torch.simplex import SolveStatus
    from relp_tpu_torch.testing import objectives_digest, scenario_family

    providers = scenario_family(**fam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = solve_batch(providers, _batch_config(), certify=True,
                          shared_structure=True, warm_start_basis=warm_start_basis)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    bad = [k for k, r in enumerate(results)
           if r.status is not SolveStatus.FINITE_OPTIMUM or not r.stats.certified]
    _check(not bad, f"{label}: LPs not certified optimal: {bad[:10]}")
    digest = objectives_digest(r.exact_objective for r in results)
    _check(digest == digest_want, f"{label}: digest {digest}")
    fallbacks = sum(bool(r.stats.batch_fallback) for r in results)
    pivots = sum(r.stats.iterations for r in results)
    certify_s = sum(r.stats.certify_time_s for r in results)
    solve_s = max(r.stats.wall_time_s for r in results)
    highs = _highs_check(np, providers, results, (0, len(results) // 2, len(results) - 1))
    _line(
        f"batch/{label}", scenarios=len(results),
        shape=_lowered_shape(fam["m"], fam["n"], fam["seed"]),
        certified=len(results), fallbacks=fallbacks, digest_ok=True,
        highs_rel_diff=f"{highs:.2e}", pivots=pivots,
        phase1_pivots=sum(r.stats.phase1_iterations for r in results),
        dual_pivots=sum(r.stats.dual_iterations for r in results),
        wall_s=f"{wall:.3f}", device_solve_s=f"{solve_s:.3f}",
        certify_s=f"{certify_s:.3f}",
        device_pivots_per_s=f"{pivots / solve_s:.0f}",
        launches_resident=batch_pivot.LAUNCHES_RESIDENT,
        launches_blocked=batch_pivot.LAUNCHES_BLOCKED,
        peak_device_MB=f"{peak / 1e6:.1f}",
    )
    return results


def phase_batch_memory(torch):
    """Peak device memory of solve_batch (no certification) on each cold
    family, with the one shared tableau that lower_batch hands out and with
    B stacked copies of it (the first port's layout, made here by a
    lower_batch that returns A.contiguous()): the same results, and the
    bytes the shared tableau saves."""
    from relp_tpu_torch.parallel import batch_driver, solve_batch
    from relp_tpu_torch.testing import FAMILIES, scenario_family

    kept = batch_driver.lower_batch

    def with_copies(*args, **kwargs):
        problems, A, *rest = kept(*args, **kwargs)
        return (problems, A.contiguous(), *rest)

    for name, fam in FAMILIES.items():
        peaks, outcomes = {}, {}
        for layout, lower in (("shared", kept), ("copies", with_copies)):
            providers = scenario_family(**fam)
            batch_driver.lower_batch = lower
            try:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                results = solve_batch(providers, _batch_config(), certify=False,
                                      shared_structure=True)
                torch.cuda.synchronize()
                peaks[layout] = torch.cuda.max_memory_allocated()
            finally:
                batch_driver.lower_batch = kept
            outcomes[layout] = [(r.status.value, tuple(r.basis), r.stats.iterations)
                                for r in results]
        _check(outcomes["shared"] == outcomes["copies"],
               f"{name}: one shared tableau and B copies solve differently")
        M, N = _family_shapes()[name]
        _line(
            "batch/memory", family=name, scenarios=fam["count"],
            peak_shared_MB=f"{peaks['shared'] / 1e6:.1f}",
            peak_copies_MB=f"{peaks['copies'] / 1e6:.1f}",
            saved_MB=f"{(peaks['copies'] - peaks['shared']) / 1e6:.1f}",
            copies_of_the_tableau_MB=f"{(fam['count'] - 1) * M * N * 4 / 1e6:.1f}",
            same_results=True,
        )


@contextlib.contextmanager
def _counting_chunks(calls):
    """Count the chunk runners that solve_batch calls, by name."""
    from relp_tpu_torch.parallel import batch_driver

    names = ("batched_run_chunk", "batched_dual_run_chunk", "megakernel_run_chunk")
    kept = {n: getattr(batch_driver, n) for n in names}

    def counted(name):
        def run(*args, **kwargs):
            calls[name] += 1
            return kept[name](*args, **kwargs)
        return run

    for n in names:
        calls[n] = 0
        setattr(batch_driver, n, counted(n))
    try:
        yield
    finally:
        for n, fn in kept.items():
            setattr(batch_driver, n, fn)


def phase_batch_warm(torch, np):
    """The warm family (the resident family's LP, +-40% wobbles) started
    from the optimum of its unperturbed base: every scenario needs dual
    pivots.  Its pinned digest (the JAX package's cold solve), no phase 1,
    the dual chunks and the phase-2 re-verification on the batched torch
    path, and no batched-pivot kernel launch."""
    from relp_tpu_torch.ops import batch_pivot
    from relp_tpu_torch.simplex import SolveStatus, solve_relaxation
    from relp_tpu_torch.testing import (
        WARM_FAMILY,
        WARM_FAMILY_OBJECTIVES_SHA256,
        scenario_base,
    )

    gf, counts = scenario_base(WARM_FAMILY["m"], WARM_FAMILY["n"], WARM_FAMILY["seed"])
    base = solve_relaxation(gf.derive_matrix_data(counts), _batch_config())
    _check(base.status is SolveStatus.FINITE_OPTIMUM, f"warm base {base.status}")
    before = (batch_pivot.LAUNCHES_RESIDENT, batch_pivot.LAUNCHES_BLOCKED)
    calls = {}
    with _counting_chunks(calls):
        results = phase_batch_family(torch, np, "warm", WARM_FAMILY,
                                     WARM_FAMILY_OBJECTIVES_SHA256,
                                     warm_start_basis=base.basis)
    in_batch = [r for r in results if not r.stats.batch_fallback]
    _check(all(r.stats.phase1_iterations == 0 for r in in_batch),
           "warm restart did not engage")
    with_dual = sum(r.stats.dual_iterations > 0 for r in in_batch)
    _check(2 * with_dual > len(results),
           f"only {with_dual} of {len(results)} scenarios took dual pivots")
    _check(calls["batched_dual_run_chunk"] > 0, "no dual chunk ran")
    _check(calls["batched_run_chunk"] > 0,
           "phase 2 did not run on the batched torch path")
    _check(calls["megakernel_run_chunk"] == 0
           and (batch_pivot.LAUNCHES_RESIDENT, batch_pivot.LAUNCHES_BLOCKED) == before,
           "a batched-pivot kernel ran after the warm restart")
    _line(
        "batch/warm", lps_with_dual_pivots=with_dual,
        max_dual_pivots=max(r.stats.dual_iterations for r in in_batch),
        phase2_pivots=sum(r.stats.iterations - r.stats.dual_iterations
                          for r in in_batch),
        dual_chunks=calls["batched_dual_run_chunk"],
        phase2_torch_chunks=calls["batched_run_chunk"],
        megakernel_chunks=calls["megakernel_run_chunk"],
    )


def phase_batch_chunk(torch, np):
    """Marginal pivots/s of the whole batch from the phase-2 start, kernel
    vs plain path: the median of 8 interleaved (K - 10)-pivot differences,
    with a host read of the pivot count in the timed region.  K is at most
    150 and below the fewest phase-2 pivots of any LP (found by one kernel
    chunk), so that every LP pivots throughout the window on both paths and
    the plain path runs no masked no-op iterations."""
    from relp_tpu_torch.parallel.batch import batched_run_chunk, megakernel_run_chunk
    from relp_tpu_torch.simplex.kernels import PRICE_STEEPEST

    cfg = _batch_config()
    tol = dict(opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol, degen_tol=cfg.feas_tol)
    rates = {}
    for name in ("resident", "blocked"):
        A, c2, cand, st = _family_phase2_start(torch, name)
        B = A.shape[0]
        start = int(st.iteration.sum())

        def run(path, chunk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if path == "kernel":
                out = megakernel_run_chunk(st, A, c2, cand, chunk=chunk, **tol)
            else:
                out = batched_run_chunk(st, A, A, c2, cand, pricing=PRICE_STEEPEST,
                                        chunk=chunk, **tol)
            pivots = int(out.iteration.sum())  # the host read, inside the timing
            return time.perf_counter() - t0, pivots - start

        probe = megakernel_run_chunk(st, A, c2, cand, chunk=150, **tol)
        fewest = int((probe.iteration - st.iteration).min())
        big = min(150, fewest - max(5, fewest // 10))
        _check(big >= 30, f"{name}: only {fewest} phase-2 pivots in the fewest LP")
        for path in ("kernel", "plain"):  # warm up outside the timed region
            run(path, 10)
        est = {"kernel": [], "plain": []}
        counts = {}
        for rep in range(8):
            order = ("kernel", "plain") if rep % 2 == 0 else ("plain", "kernel")
            for path in order:
                t_small, i_small = run(path, 10)
                t_big, i_big = run(path, big)
                counts[path] = (i_small, i_big)
                est[path].append((i_big - i_small) / (t_big - t_small))
        med = {p: float(np.median(v)) for p, v in est.items()}
        quart = {p: "/".join(f"{q:.0f}" for q in np.percentile(v, [25, 75]))
                 for p, v in est.items()}
        rates[name] = med
        _line(
            "batch/chunk", family=name, shape="x".join(map(str, A.shape)),
            method=f"median of 8 interleaved ({big}-10)-pivot differences, "
            "phase-2 start",
            fewest_lp_phase2_pivots=fewest,
            kernel_pivots_10_K=counts["kernel"], plain_pivots_10_K=counts["plain"],
            all_active=all(c == (10 * B, big * B) for c in counts.values()),
            kernel_pivots_per_s=f"{med['kernel']:.0f}",
            plain_pivots_per_s=f"{med['plain']:.0f}",
            kernel_q1_q3=quart["kernel"], plain_q1_q3=quart["plain"],
        )
    return rates


_REFUSED = ("jax", "jaxlib", "relp_tpu")


class _Refuse:
    """Import hook that refuses jax, jaxlib and the JAX package: the port
    runs without them, and nothing of it may pull them in even where they
    are installed."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _REFUSED:
            raise ImportError(f"chip_smoke runs the port without {name}")
        return None


def main() -> int:
    sys.meta_path.insert(0, _Refuse())
    if not os.path.isdir(os.path.join(HERE, "relp_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    import numpy as np

    from relp_tpu_torch.ops import batch_pivot, price_scan
    from relp_tpu_torch.testing import FAMILIES, FAMILY_OBJECTIVES_SHA256

    device = phase_device(torch)
    phase_build()
    main_shape, errors, times = phase_kernel(torch, np, device)
    probes = phase_probe(torch, device)
    batch_errors, batch_times = phase_batch_kernel(torch, np)

    price_scan.LAUNCHES = 0  # counts from here on are the main path's
    phase_main_small(torch)
    phase_main_real(torch, np)
    launches = price_scan.LAUNCHES
    _check(launches > 0, "the main path never launched the scan kernel")

    phase_chunk_loop(torch, np, device, times)

    # The scenario-batch path, once per family; the counts are each run's.
    batch_launches = {}
    for name, counter in (("resident", "LAUNCHES_RESIDENT"),
                          ("blocked", "LAUNCHES_BLOCKED")):
        batch_pivot.LAUNCHES_RESIDENT = batch_pivot.LAUNCHES_BLOCKED = 0
        phase_batch_family(torch, np, name, FAMILIES[name],
                           FAMILY_OBJECTIVES_SHA256[name])
        batch_launches[name] = getattr(batch_pivot, counter)
        _check(batch_launches[name] > 0,
               f"the {name} family never launched batch_pivot_kernel<{name}>")
    phase_batch_memory(torch)
    batch_pivot.LAUNCHES_RESIDENT = batch_pivot.LAUNCHES_BLOCKED = 0
    phase_batch_warm(torch, np)
    phase_batch_chunk(torch, np)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in _REFUSED)
    _check(not loaded, f"imported: {loaded}")

    main_case = (*main_shape, torch.float32)
    kern_ms, plain_ms, library_ms, bound_ms, bound_by = times[main_case]
    kernels = [{
        "name": "fused_price_scan",
        "route": "cuda",
        "source": "relp_tpu_torch/csrc/price_scan.cu",
        "replaces": "relp_tpu/ops/pallas_scan.py:102",
        "launches": launches,
        "max_abs_err": errors[main_case],
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "torch.matmul(P, A), TF32 off, without the d/gamma epilogue",
        "shape": list(main_shape),
    }]
    for name, fn, replaces in (
        ("resident", "batched_pivot_chunk", "relp_tpu/ops/pallas_batch.py:865"),
        ("blocked", "batched_pivot_chunk_blocked", "relp_tpu/ops/pallas_batch.py:724"),
    ):
        case = (name, f"phase2:{name}", False)
        errs = [e for (_v, label, _s), e in batch_errors.items()
                if label.endswith(f":{name}")]
        kernels.append({
            "name": fn,
            "route": "cuda",
            "source": "relp_tpu_torch/csrc/batch_pivot.cu",
            "replaces": replaces,
            "launches": batch_launches[name],
            # The checks are relative to 1 + max|plain| per field; the
            # absolute error follows the scale of the largest field.
            "max_abs_err": max(a for a, _r in errs),
            "max_rel_err": max(r for _a, r in errs),
            "ms": batch_times[case][0],
            "plain_ms": batch_times[case][1],
            "bound_ms": batch_times[case][2],
            "bound_by": batch_times[case][3],
            "library_ms": None,
            "shape": [FAMILIES[name]["count"], *_family_shapes()[name]],
            "per": "one 25-pivot chunk of the whole batch from the phase-2 start",
        })
    for kind, fields in probes.items():
        kernels.append({
            "name": f"probe_dot_{kind}",
            "route": "cuda",
            "source": "relp_tpu_torch/csrc/probe_dot.cu",
            "replaces": "scripts/probe_dot_precision.py:"
                        + {"tf32": "54", "tf32x3": "64", "outer": "74"}[kind],
            **fields,
            "shape": [256, 256],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
