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

The other solve modes follow, each with every kernel's launch count from 0
just before it (a `launches` line after each):

 13. mip/small     knap6 through the CLI with --mip, --first-order and
                   --basis-inverse lu: exact -30, certified; the MIP's best
                   bound -30 and its incumbent exactly feasible; the
                   first-order crossover's warm finish (fewer pivots than
                   the cold solve);
 14. mip/real      solve_mip (f32 defaults: cuts, strong branching, dive;
                   64 nodes a wave, cut at 384 nodes) on the Chu-Beasley
                   knapsack of relp_tpu_torch.testing: a rigorous exact
                   best bound above the root LP's and no higher than
                   HiGHS's optimum, a stated minimum of node LPs solved in
                   the batch, an incumbent (if one is found) exactly
                   feasible and no better; nodes, batched solves,
                   fallbacks, the certification share.  After its launch
                   counts are read, each kernel is held against its plain
                   version on the inputs this path gave it (mip/kernel);
 15. mip/real64    the same knapsack with --dtype float64 and 16 nodes a
                   wave to a certified optimum: HiGHS's, an exactly
                   feasible incumbent, the waves in the batch;
 16. first_order/real
                   solve_first_order on main/real's LP: certified, the
                   pinned digest; PDHG statistics, crossover pivots (a cold
                   finish: the crossover basis is refused), wall split;
 17. first_order/pdhg
                   pdhg_solve on a 2048 x 8192 LP (f32 A of 67 MB):
                   iterations/s, the device time per iteration of one chunk
                   against two reads of A, the KKT residuals of the
                   returned point in f64 on the host against the card's,
                   and its primal residual against the same call's in f64
                   on the CPU (relp_tpu_torch.tools.pdhg_check);
 18. lu/real, lu/profile
                   main/real's LP on the LU engine: certified, the pinned
                   digest, ms per pivot; one chunk of it replayed under the
                   profiler for launches and device-busy time per pivot.

Then a JSON line describing each kernel (six: the scan, the two
batched-pivot kernels and the probe's three) with its time, its plain
version's, its bound (the larger of its bytes at 3.35 TB/s and its
operations at the H100's peak for their type), the library yardstick,
its error on mip/real's inputs and its launches on each of the paths
13-18, and as the last line {"ok":
true, "device": {...}}.  Any failure raises: the exit code is then
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


def _hold_scan(torch, label, tol, P, A, c, gamma, gamma_q):
    """fused_price_scan against its plain version on the same inputs: d and
    gamma finite and within tol * (1 + max|plain|).  Returns (the largest
    absolute error, "d:rel,gamma:rel")."""
    from relp_tpu_torch.ops import price_scan

    outs_k = price_scan.fused_price_scan(P, A, c, gamma, gamma_q)
    outs_p = price_scan.fused_price_scan_reference(P, A, c, gamma, gamma_q)
    torch.cuda.synchronize()
    worst, errs = 0.0, []
    for name, kern, plain in zip(("d", "gamma"), outs_k, outs_p):
        kern64, plain64 = kern.double(), plain.double()
        _check(bool(torch.isfinite(kern64).all()), f"{label}: non-finite {name}")
        err = float((kern64 - plain64).abs().max())
        scale = float(plain64.abs().max())
        _check(err <= tol * (1.0 + scale),
               f"{name} at {label}: |err| {err:.3e} > {tol:g} * (1 + {scale:.3e})")
        worst = max(worst, err)
        errs.append(f"{name}:{err / (1.0 + scale):.3e}")
    return worst, ",".join(errs)


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
        errors[(M, N, dtype)], errs = _hold_scan(torch, f"{M}x{N} {dtype}", tol,
                                                 P, A, c, g, gq)
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
            rel_err=errs, tol=f"{tol:g}*(1+scale)",
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
    return payload["iterations"]


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


def _hold_batch(torch, kern, label, args, kw):
    """A batched-pivot kernel against batched_pivot_chunk_reference on the
    same inputs ``args`` (A, c, cand, then the state): two launches
    bitwise equal, the same bases, statuses and iteration counts as the
    plain version, the float state within _BATCH_TOL, and on one shared
    tableau (batch stride 0) the bits of B stacked copies.  Returns (the
    largest absolute error, {field: error relative to 1 + max|plain|},
    the kernel's outputs by field)."""
    from relp_tpu_torch.ops import batch_pivot

    A = args[0]
    out_k = kern(*args, **kw)
    out_k2 = kern(*args, **kw)
    torch.cuda.synchronize()
    out_p = batch_pivot.batched_pivot_chunk_reference(*args, **kw)
    torch.cuda.synchronize()
    k, k2, p = (dict(zip(_OUT_FIELDS, o)) for o in (out_k, out_k2, out_p))
    for f in _OUT_FIELDS:
        _check(torch.equal(k[f], k2[f]), f"{label}: {f} differs between two launches")
    for f in ("basis", "in_basis", "status", "iteration"):
        same = (k[f] == p[f]).reshape(k[f].shape[0], -1).all(dim=1)
        _check(bool(same.all()), f"{label}: {f} differs for LPs "
               f"{torch.nonzero(~same).flatten().tolist()[:10]}")
    rel, worst = {}, 0.0
    for f, t in _BATCH_TOL.items():
        scale = 1.0 + float(p[f].abs().max())
        err = float((k[f].double() - p[f].double()).abs().max())
        rel[f], worst = err / scale, max(worst, err)
        _check(err <= t * scale, f"{label}: {f} |err| {err:.3e} > {t:g} * {scale:.3e}")
    if A.stride(0) == 0:  # one tableau for the batch: the bits of B copies
        out_c = dict(zip(_OUT_FIELDS, kern(A.contiguous(), *args[1:], **kw)))
        torch.cuda.synchronize()
        for f in _OUT_FIELDS:
            _check(torch.equal(k[f], out_c[f]),
                   f"{label}: {f} differs between one shared tableau and B copies")
    return worst, rel, k


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
            abs_err, rel, k = _hold_batch(torch, kern, f"{label} {variant} "
                                          f"stop_at_zero={stop_at_zero}", args, kw)
            errors[(variant, label, stop_at_zero)] = (abs_err, max(rel.values()))
            shared = A.stride(0) == 0
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


def _launch_counts():
    """Every kernel's launch counter, by the name of its JSON entry."""
    from relp_tpu_torch.ops import batch_pivot, price_scan
    from relp_tpu_torch.tools import probe_dot_precision as probe

    return {
        "fused_price_scan": price_scan.LAUNCHES,
        "batched_pivot_chunk": batch_pivot.LAUNCHES_RESIDENT,
        "batched_pivot_chunk_blocked": batch_pivot.LAUNCHES_BLOCKED,
        **{f"probe_dot_{kind}": probe.LAUNCHES[kind] for kind in probe.KINDS},
    }


def _zero_launch_counts():
    from relp_tpu_torch.ops import batch_pivot, price_scan
    from relp_tpu_torch.tools import probe_dot_precision as probe

    price_scan.LAUNCHES = 0
    batch_pivot.LAUNCHES_RESIDENT = batch_pivot.LAUNCHES_BLOCKED = 0
    for kind in probe.KINDS:
        probe.LAUNCHES[kind] = 0


def _rows_hold(gf, values) -> bool:
    """The point ``values`` (variable name -> Fraction; absent means 0)
    satisfies every row, bound and integrality of the GeneralForm ``gf``
    (read before presolve) in exact arithmetic."""
    from fractions import Fraction

    from relp_tpu_torch.data.elements import RangedKind
    from relp_tpu_torch.data.general_form import VariableType

    x = [Fraction(values.get(name, 0)) for name, _kind in gf.original_variables]
    for var, v in zip(gf.variables, x):
        if var.lower_bound is not None and v < var.lower_bound:
            return False
        if var.upper_bound is not None and v > var.upper_bound:
            return False
        if var.variable_type is VariableType.INTEGER and v.denominator != 1:
            return False
    lhs = [Fraction(0)] * len(gf.b)
    for j, v in enumerate(x):
        if v:
            for i, a in gf.constraints.iter_column(j):
                lhs[i] += a * v
    for value, rel, b in zip(lhs, gf.constraint_types, gf.b):
        if rel.kind is RangedKind.EQUAL and value != b:
            return False
        if rel.kind in (RangedKind.LESS, RangedKind.RANGE) and value > b:
            return False
        if rel.kind is RangedKind.GREATER and value < b:
            return False
        if rel.kind is RangedKind.RANGE and value < b - rel.range:
            return False
    return True


def phase_mip_small(cold_pivots):
    """knap6 through the CLI as a MIP, by PDHG + crossover and on the LU
    engine (CUDA by default): exact -30, certified; the MIP's best bound is
    -30 and its incumbent holds every row exactly; the crossover's warm
    finish takes fewer pivots than main/small's cold solve
    (``cold_pivots``)."""
    from relp_tpu_torch.__main__ import main as cli
    from relp_tpu_torch.io import load_general_form

    path = os.path.join(HERE, "tests", "data", "knap6.mps")
    for mode in (["--mip"], ["--first-order"], ["--basis-inverse", "lu"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli(["solve", "--json", "--values", *mode, path])
        payload = json.loads(out.getvalue())
        label = " ".join(mode)
        _check(rc == 0 and payload["status"] == "finite_optimum", f"knap6 {label} {payload}")
        _check(payload["objective"] == "-30" and payload["certified"] is True,
               f"knap6 {label} {payload}")
        fields = dict(mode=label.replace(" ", ":"), objective=payload["objective"],
                      certified=payload["certified"])
        if mode == ["--mip"]:
            _check(payload["best_bound"] == "-30", f"knap6 --mip {payload}")
            _check(_rows_hold(load_general_form(path), payload["values"]),
                   "knap6 --mip: the incumbent breaks a row")
            fields.update(best_bound=payload["best_bound"], gap=payload["gap"],
                          nodes_solved=payload["nodes_solved"], incumbent_feasible=True)
        elif mode == ["--first-order"]:
            # The crossover basis is taken: the warm finish needs fewer
            # pivots than the cold solve of main/small.
            _check(payload["iterations"] < cold_pivots,
                   f"knap6 --first-order: {payload['iterations']} pivots, the cold "
                   f"solve {cold_pivots}: the crossover basis was refused")
            fields.update(pivots=payload["iterations"], cold_pivots=cold_pivots,
                          crossover_warm=True)
        else:
            fields.update(pivots=payload["iterations"],
                          phase1_pivots=payload["phase1_iterations"])
        _line("mip/small", **fields)


@contextlib.contextmanager
def _wrapped(module, name, wrapper):
    """``module.name`` replaced by ``wrapper(original)`` inside the block."""
    kept = getattr(module, name)
    setattr(module, name, wrapper(kept))
    try:
        yield
    finally:
        setattr(module, name, kept)


@contextlib.contextmanager
def _counting_solves(tally):
    """Count the LP solves that branch & bound asks for through the module
    attributes its lazy imports read: the solve_batch calls, their LPs and
    single-LP fallbacks (``stats.batch_fallback``), the single-LP solves
    outside a batch, and the certification time the returned results
    report (``stats.certify_time_s``).  ``tally["inside"]`` is the depth of
    solve_batch calls in progress."""
    from relp_tpu_torch.parallel import batch_driver
    from relp_tpu_torch.simplex import driver

    tally.update(batched_solves=0, batched_lps=0, fallbacks=0, single_solves=0,
                 certify_s=0.0, inside=0)

    def batch(solve_batch):
        def run(providers, *args, **kwargs):
            tally["inside"] += 1
            try:
                results = solve_batch(providers, *args, **kwargs)
            finally:
                tally["inside"] -= 1
            tally["batched_solves"] += 1
            tally["batched_lps"] += len(results)
            tally["fallbacks"] += sum(bool(r.stats.batch_fallback) for r in results)
            tally["certify_s"] += sum(r.stats.certify_time_s for r in results)
            return results
        return run

    def single(solve_relaxation):
        def run(*args, **kwargs):
            result = solve_relaxation(*args, **kwargs)
            if not tally["inside"]:  # a batch's fallbacks count with the batch
                tally["single_solves"] += 1
                tally["certify_s"] += result.stats.certify_time_s
            return result
        return run

    with _wrapped(batch_driver, "solve_batch", batch), \
            _wrapped(driver, "solve_relaxation", single):
        yield


def _keeping_inputs(module, name, kept, when=lambda *args: True):
    """``_wrapped``: the inputs of the first call of ``module.name`` for
    which ``when(*args)`` holds are kept in ``kept[name]`` as (args, kwargs),
    contiguous tensors cloned (a tableau expanded over a batch is read-only
    and kept as it is)."""
    import torch

    def wrapper(fn):
        def run(*args, **kwargs):
            if name not in kept and when(*args):
                kept[name] = (tuple(a.clone() if torch.is_tensor(a) and a.is_contiguous()
                                    else a for a in args), dict(kwargs))
            return fn(*args, **kwargs)
        return run

    return _wrapped(module, name, wrapper)


def _highs_mip(np, W, capacity, profit):
    """HiGHS (scipy.optimize.milp, 60 s) on the knapsack in the minimize
    sense: (status, primal objective, dual bound)."""
    import scipy.optimize as so

    res = so.milp(-profit.astype(float),
                  constraints=so.LinearConstraint(W.astype(float), -np.inf,
                                                  capacity.astype(float)),
                  integrality=np.ones(len(profit)), bounds=so.Bounds(0, 1),
                  options={"time_limit": 60})
    fun = None if res.fun is None else float(res.fun)
    return res.status, fun, getattr(res, "mip_dual_bound", None)


_HIGHS = {}


def _mknap_highs(np):
    """HiGHS on the Chu-Beasley knapsack, once: (status, objective, bound)."""
    from relp_tpu_torch.testing import MKNAP, mknap_data

    if not _HIGHS:
        _HIGHS["result"] = _highs_mip(np, *mknap_data(**MKNAP))
    return _HIGHS["result"]


def _solve_mknap(torch, np, label, cfg, min_in_batch, tally, **limits):
    """solve_mip on the Chu-Beasley knapsack with the LP solves counted;
    the checks every run of it passes: a rigorous exact best bound strictly
    above the root LP's and no higher than HiGHS's optimum, at least
    ``min_in_batch`` node LPs solved inside solve_batch (not sent to the
    single-LP fallback), and an incumbent (where one is found) that holds
    every row exactly, is the objective of its values, and is no better
    than HiGHS's optimum.  Prints the run's line; returns the MIP result,
    the counts in ``tally`` (``_counting_solves``)."""
    from fractions import Fraction

    from relp_tpu_torch.mip import solve_mip
    from relp_tpu_torch.testing import MKNAP, mknap, mknap_data

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _counting_solves(tally):
        mip = solve_mip(mknap(**MKNAP), cfg, **limits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(tally["batched_solves"] > 0 and tally["single_solves"] > 0,
           f"{label}: counted no solves ({tally}): the counting missed the path")
    in_batch = tally["batched_lps"] - tally["fallbacks"]
    _check(in_batch >= min_in_batch, f"{label}: {in_batch} node LPs solved in the "
           f"batch, fewer than {min_in_batch}")
    _check(mip.best_bound is not None and mip.best_bound_exact,
           f"{label}: no rigorous best bound ({mip.best_bound}, "
           f"exact={mip.best_bound_exact})")
    _check(mip.best_bound > mip.root_objective,
           f"{label}: best bound {mip.best_bound} not above the root LP's "
           f"{mip.root_objective}")
    status, z_highs, bound_highs = _mknap_highs(np)
    if status == 0:  # optimal: the integer optimum is HiGHS's value rounded
        z = round(z_highs)
        _check(mip.best_bound <= z, f"{label}: best bound {mip.best_bound} above "
               f"HiGHS's optimum {z}")
    incumbent = "none"
    if mip.objective is not None:
        _W, _capacity, profit = mknap_data(**MKNAP)
        values = dict(mip.solution.solution_values)
        x = np.array([int(Fraction(values.get(f"x{j}", 0))) for j in range(len(profit))])
        _check(_rows_hold(mknap(**MKNAP), values), f"{label}: the incumbent breaks a row")
        _check(Fraction(int(-(profit @ x))) == mip.objective,
               f"{label}: objective {mip.objective} is not the incumbent's")
        if status == 0:
            _check(z <= mip.objective, f"{label}: incumbent {mip.objective} beats "
                   f"HiGHS's optimum {z}")
        incumbent = str(mip.objective)
    if status != 0:  # HiGHS stopped early: the two intervals must overlap
        top = float(mip.objective) if mip.objective is not None else float("inf")
        _check(float(mip.best_bound) <= z_highs
               and (bound_highs is None or bound_highs <= top),
               f"{label}: [{mip.best_bound}, {top}] misses HiGHS's "
               f"[{bound_highs}, {z_highs}]")
    _line(
        label, instance="mknapcb-class", m=MKNAP["m"], n=MKNAP["n"],
        tightness=MKNAP["tightness"], seed=MKNAP["seed"], dtype=cfg.dtype,
        **limits, status=mip.status.value,
        incumbent=incumbent, incumbent_feasible=incumbent != "none" or "n/a",
        dive_lps=mip.dive_lps, dive_incumbent=mip.dive_incumbent,
        nodes_solved=mip.nodes_solved, nodes_pruned=mip.nodes_pruned,
        node_limit_hit=mip.node_limit_hit, time_limit_hit=mip.time_limit_hit,
        best_bound=f"{float(mip.best_bound):.6f}", best_bound_exact=mip.best_bound_exact,
        gap=f"{float(mip.gap):.3e}" if mip.gap is not None else "none",
        certified=mip.certified, root_objective=f"{float(mip.root_objective):.6f}",
        highs_status=status, highs_objective=z_highs, highs_bound=bound_highs,
        batched_solves=tally["batched_solves"], batched_lps=tally["batched_lps"],
        batch_fallbacks=tally["fallbacks"], in_batch=in_batch,
        single_solves=tally["single_solves"],
        wall_s=f"{wall:.3f}", certify_s=f"{tally['certify_s']:.3f}",
        certify_share=f"{tally['certify_s'] / wall:.3f}",
    )
    return mip


# Node LPs that mip/real must solve inside the batch: 35 of 394 did on an
# H100 (383 nodes; PERF.md), the others fell back to the single-LP driver.
_MIN_IN_BATCH_F32 = 16


def phase_mip_real(torch, np):
    """solve_mip in its default configuration (f32; Gomory and cover cuts,
    strong branching, the rounding dive) on the Chu-Beasley knapsack, 64
    nodes a wave, cut at 384 nodes (_solve_mknap's checks).  The node
    count, not the clock, ends it, so that every host reaches a whole wave
    of node LPs too deep for the resident kernel (it runs the blocked one;
    none came in the 255 nodes a slow host reached in 90 s); 300 s only
    stop a runaway.  The
    inputs of the first launch of each batched-pivot kernel on a whole
    node wave (its cold batch) and of the first scan launch inside a batch
    (a node LP that
    fell back to the single-LP driver) are kept: returns the replay that
    holds each kernel against its plain version on them, to run once the
    path's launches are read."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.ops import batch_pivot
    from relp_tpu_torch.simplex import kernels

    tally, kept = {}, {}

    def wave(A, *_rest):  # a whole node wave (strong branching's are narrower)
        return A.shape[0] == 64

    with _keeping_inputs(batch_pivot, "batched_pivot_chunk", kept, when=wave), \
            _keeping_inputs(batch_pivot, "batched_pivot_chunk_blocked", kept,
                            when=wave), \
            _keeping_inputs(kernels, "fused_price_scan", kept,
                            when=lambda *_args: tally.get("inside", 0) > 0):
        _solve_mknap(torch, np, "mip/real", SolverConfig(), _MIN_IN_BATCH_F32,
                     tally, batch_width=64, node_limit=384, time_limit_s=300)
    missing = {"batched_pivot_chunk", "batched_pivot_chunk_blocked",
               "fused_price_scan"} - set(kept)
    _check(not missing, f"mip/real never launched {sorted(missing)}")
    return lambda: _replay_mip_kernels(torch, kept)


def _replay_mip_kernels(torch, kept):
    """Each kernel of mip/real against its plain version on the inputs the
    path gave it (``phase_mip_real``), with the tolerances of
    phase_kernel and phase_batch_kernel.  Returns {kernel: largest
    absolute error}."""
    from relp_tpu_torch.ops import batch_pivot

    errors = {}
    for name in ("batched_pivot_chunk", "batched_pivot_chunk_blocked"):
        args, kw = kept[name]
        before = _launch_counts()[name]
        abs_err, rel, out = _hold_batch(torch, getattr(batch_pivot, name),
                                        f"mip/real {name}", args, kw)
        launched = _launch_counts()[name] - before
        _check(launched >= 2, f"mip/real replay: {name} launched {launched} times")
        pivots = out["iteration"] - args[10]
        errors[name] = abs_err
        _line("mip/kernel", kernel=name, shape="x".join(map(str, args[0].shape)),
              launched=launched,
              chunk=kw["chunk"], stop_at_zero=kw.get("stop_at_zero", False),
              pivots=int(pivots.sum()), min_lp_pivots=int(pivots.min()),
              identical="basis,in_basis,status,iteration", repeat_bitwise=True,
              rel_err=",".join(f"{f}:{v:.2e}" for f, v in rel.items()))
    args, _kw = kept["fused_price_scan"]
    before = _launch_counts()["fused_price_scan"]
    errors["fused_price_scan"], errs = _hold_scan(torch, "mip/real node LP", 1e-5,
                                                  *args)
    _check(_launch_counts()["fused_price_scan"] == before + 1,
           "mip/real replay: the scan kernel did not launch")
    _line("mip/kernel", kernel="fused_price_scan", launched=1,
          shape="x".join(map(str, args[1].shape)), dtype=str(args[1].dtype),
          rel_err=errs, tol="1e-05*(1+scale)")
    return errors


def phase_mip_real64(torch, np):
    """The same knapsack to a proven optimum: solve_mip with --dtype float64
    and the CLI's default 16 nodes a wave (f64 node LPs pass the batch
    driver's residual gates, so the waves stay in the batch).  Besides
    _solve_mknap's checks: optimal and certified, the objective HiGHS's
    optimum, the best bound equal to it, nearly every node LP solved in the
    batch."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.simplex import SolveStatus

    tally = {}
    mip = _solve_mknap(torch, np, "mip/real64", SolverConfig(dtype="float64"), 1,
                       tally, batch_width=16, node_limit=4096, time_limit_s=300)
    status, z_highs, _bound = _mknap_highs(np)
    _check(mip.status is SolveStatus.FINITE_OPTIMUM and mip.certified,
           f"mip/real64: {mip.status} certified={mip.certified}")
    _check(mip.objective is not None and mip.best_bound == mip.objective,
           f"mip/real64: objective {mip.objective}, best bound {mip.best_bound}")
    if status == 0:
        _check(mip.objective == round(z_highs),
               f"mip/real64: optimum {mip.objective}, HiGHS {z_highs}")
    _check(10 * tally["fallbacks"] <= tally["batched_lps"],
           f"mip/real64: {tally['fallbacks']} of {tally['batched_lps']} node LPs "
           "left the batch")


def _reconstructed_objective(gf, md, result):
    """The full-space exact objective of a reduced certified result."""
    reduced = md.reconstruct_solution(result.exact_bfs)
    return gf.compute_full_solution_with_reduced_solution(reduced).objective_value


def phase_first_order_real(torch):
    """solve_first_order (PDHG + crossover) on main/real's LP after the same
    presolve and standardize as the CLI: certified, main/real's pinned
    digest; the PDHG statistics, the crossover's pivots, the wall split.
    PDHG stops unconverged, the crossover refuses its basis and the finish
    is a cold solve: this phase covers that route; mip/small's
    --first-order covers the warm finish."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.firstorder import solve_first_order
    from relp_tpu_torch.simplex import SolveStatus
    from relp_tpu_torch.testing import (
        REAL_SIZE,
        REAL_SIZE_OBJECTIVE_SHA256,
        generated_lp,
    )

    gf = generated_lp(**REAL_SIZE)
    gf.presolve()
    md = gf.derive_matrix_data(gf.standardize())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = solve_first_order(md, SolverConfig())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(result.status is SolveStatus.FINITE_OPTIMUM and result.stats.certified,
           f"first_order/real: {result.status} certified={result.stats.certified}")
    digest = hashlib.sha256(
        str(_reconstructed_objective(gf, md, result)).encode()).hexdigest()
    _check(digest == REAL_SIZE_OBJECTIVE_SHA256, f"first_order/real digest {digest}")
    fo = result.first_order_stats
    _line(
        "first_order/real", m=REAL_SIZE["m"], n=REAL_SIZE["n"], status=result.status.value,
        certified=True, digest_ok=True, pdhg_iterations=fo.iterations,
        restarts=fo.restarts, converged=fo.converged,
        primal_residual=f"{fo.primal_residual:.3e}",
        dual_residual=f"{fo.dual_residual:.3e}", gap=f"{fo.gap:.3e}",
        crossover_phase1_pivots=result.stats.phase1_iterations,
        crossover_pivots=result.stats.iterations,
        wall_s=f"{wall:.3f}", pdhg_s=f"{fo.wall_time_s:.3f}",
        crossover_solve_s=f"{result.stats.wall_time_s:.3f}",
        certify_s=f"{result.stats.certify_time_s:.3f}",
        # to_arrays, the bound-row split, the lift and crossover_basis's
        # greedy QR on the host
        host_s=f"{wall - fo.wall_time_s - result.stats.wall_time_s:.3f}",
    )


# The card's f32 PDHG point may leave at most this many times the primal
# residual of the same call in f64 on the CPU (testing.PDHG_F64_CPU): a
# point that made no progress leaves about 1.  f32 left 1.65 times it on
# an H100 (PERF.md).
_PDHG_PROGRESS_FACTOR = 10.0


def phase_first_order_pdhg(torch, np, device):
    """pdhg_solve alone on the 2048 x 8192 LP of relp_tpu_torch.testing (f32,
    its matrix larger than L2; tools.pdhg_check's call): iterations/s and
    the device time of one 200-iteration chunk against its bound (A read
    twice per iteration at 3.35 TB/s); the KKT residuals of the returned
    point in f64 on the host against the port's f32 evaluation on the card,
    and its primal residual against the same call's in f64 on the CPU."""
    from relp_tpu_torch.firstorder import pdhg
    from relp_tpu_torch.testing import PDHG_F64_CPU
    from relp_tpu_torch.tools import pdhg_check

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y, st, scaled, host = pdhg_check.run(device)
    wall = time.perf_counter() - t0
    _check(np.all(np.isfinite(x)) and np.all(np.isfinite(y)), "first_order/pdhg: non-finite")
    As, bs, cs, us, xs, ys = scaled
    on_card = [torch.as_tensor(v, device=device) for v in (As, bs, cs, us)]
    xs_d, ys_d = (torch.as_tensor(v.astype(np.float32), device=device) for v in (xs, ys))
    card = pdhg._kkt(*on_card, xs_d, ys_d)
    card64 = pdhg._kkt(*(torch.as_tensor(np.asarray(v, np.float64), device=device)
                         for v in scaled))
    # Rounding floors of an evaluation in precision eps: eps times the
    # magnitudes summed in A x - b, c - y A, and the two objectives, the
    # dual one with c - y A weighted by the finite bounds (times 4).
    A64, b64, c64, u64, x64, y64 = (np.asarray(v, np.float64) for v in scaled)
    yA = np.abs(y64) @ np.abs(A64)
    lam = c64 - y64 @ A64
    u_fin = np.where(np.isfinite(u64), u64, 0.0)
    pobj = float(c64 @ x64)
    dobj = float(b64 @ y64 + np.sum(u_fin * np.minimum(lam, 0.0)))
    magnitudes = np.array([
        np.linalg.norm(np.abs(A64) @ np.abs(x64) + np.abs(b64)) / (1 + np.linalg.norm(b64)),
        np.linalg.norm(yA + np.abs(c64)) / (1 + np.linalg.norm(c64)),
        (np.abs(c64) @ np.abs(x64) + np.abs(b64) @ np.abs(y64)
         + np.sum(u_fin * (np.abs(c64) + yA))) / (1 + abs(pobj) + abs(dobj)),
    ])
    # The card's f64 evaluation agrees with the host's to 1e-9 relative;
    # its f32 one, which pdhg_solve makes, to 1e-3 besides its f32 floor.
    for dtype, got, rel in ((np.float64, card64, 1e-9), (np.float32, card, 1e-3)):
        floor = 4 * float(np.finfo(dtype).eps) * magnitudes
        for name, h, d, f in zip(("primal", "dual", "gap"), host, got, floor):
            _check(abs(h - d) <= rel * max(h, d) + f,
                   f"first_order/pdhg {name} residual: host {h:.6e} card "
                   f"{np.dtype(dtype).name} {d:.6e} floor {f:.1e}")
    progress = _PDHG_PROGRESS_FACTOR * PDHG_F64_CPU["primal"]
    _check(st.iterations == PDHG_F64_CPU["iterations"] and host[0] <= progress,
           f"first_order/pdhg: {st.iterations} iterations, primal residual "
           f"{host[0]:.3e} above {progress:.3e} ({_PDHG_PROGRESS_FACTOR:g} times "
           "the f64 CPU run's)")
    # One chunk on the card between CUDA events, from the returned point.
    A_d, b_d, c_d, u_d = on_card
    chunk = 200
    ms = _events_ms(torch, lambda: pdhg._pdhg_chunk(
        xs_d, ys_d, xs_d, ys_d, 0.0, 1e-3, 1e-3, A_d, b_d, c_d, u_d, chunk=chunk))
    bytes_per_iter = 2 * A_d.numel() * 4
    bound_ms, bound_by = _bound(bytes_per_iter, 4.0 * A_d.numel())
    _line(
        "first_order/pdhg", m=As.shape[0], n=As.shape[1], dtype="float32",
        iterations=st.iterations, restarts=st.restarts, converged=st.converged,
        wall_s=f"{wall:.3f}", iterations_per_s=f"{st.iterations / st.wall_time_s:.0f}",
        chunk_ms_per_iteration=f"{ms / chunk:.5f}",
        bound_ms_per_iteration=f"{bound_ms:.5f}", bound_by=bound_by,
        bound_share=f"{bound_ms / (ms / chunk):.3f}",
        bytes_per_iteration=bytes_per_iter,
        primal_residual=f"{st.primal_residual:.3e}",
        dual_residual=f"{st.dual_residual:.3e}", gap=f"{st.gap:.3e}",
        returned_point_host_f64=",".join(f"{v:.4e}" for v in host),
        returned_point_card_f32=",".join(f"{v:.4e}" for v in card),
        returned_point_card_f64=",".join(f"{v:.4e}" for v in card64),
        card_f32_floor=",".join(f"{v:.1e}" for v in floor),
        f64_cpu_primal=f"{PDHG_F64_CPU['primal']:.4e}",
        primal_bound=f"{progress:.4e}",
    )


def phase_lu_real(torch):
    """main/real's LP through solve_general_form on the LU engine: certified,
    the pinned digest; pivots, refactorizations, ms per pivot; then one
    phase-2 chunk of that solve replayed under the profiler for launches
    and device-busy time per pivot."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.simplex import SolveStatus, engine, solve_general_form
    from relp_tpu_torch.testing import (
        REAL_SIZE,
        REAL_SIZE_OBJECTIVE_SHA256,
        generated_lp,
    )

    kept, calls = {}, []

    def twentieth(*_args):  # keep the 20th chunk's inputs for the replay
        calls.append(1)
        return len(calls) == 20

    with _keeping_inputs(engine.LUEngine, "run_chunk", kept, when=twentieth):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, solution = solve_general_form(generated_lp(**REAL_SIZE),
                                              SolverConfig(basis_inverse="lu"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _check(result.status is SolveStatus.FINITE_OPTIMUM and result.stats.certified,
           f"lu/real: {result.status} certified={result.stats.certified}")
    digest = hashlib.sha256(str(solution.objective_value).encode()).hexdigest()
    _check(digest == REAL_SIZE_OBJECTIVE_SHA256, f"lu/real digest {digest}")
    _check("run_chunk" in kept, f"lu/real: {len(calls)} chunks, fewer than 20")
    pivots = result.stats.iterations + result.stats.phase1_iterations
    solve_s = result.stats.wall_time_s - result.stats.certify_time_s
    (self, state, *args), kwargs = kept["run_chunk"]
    run_chunk = engine.LUEngine.run_chunk
    out = run_chunk(self, state, *args, **kwargs)
    chunk_pivots = int(out.iteration) - int(state.iteration)
    _check(chunk_pivots > 0, "lu/real: the replayed chunk took no pivot")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    int(run_chunk(self, state, *args, **kwargs).iteration)
    chunk_ms = (time.perf_counter() - t1) * 1e3
    busy_ms, launches, top = _device_busy(
        torch, lambda: int(run_chunk(self, state, *args, **kwargs).iteration), chunk_pivots)
    _line(
        "lu/real", m=REAL_SIZE["m"], n=REAL_SIZE["n"], status=result.status.value,
        certified=True, digest_ok=True, pivots=result.stats.iterations,
        phase1_pivots=result.stats.phase1_iterations,
        refactorizations=result.stats.refactorizations, chunks=result.stats.chunks,
        escalations=",".join(result.stats.escalations) or "none",
        wall_s=f"{wall:.3f}", solve_s=f"{solve_s:.3f}",
        certify_s=f"{result.stats.certify_time_s:.3f}",
        solve_ms_per_pivot=f"{solve_s / pivots * 1e3:.4f}",
    )
    _line(
        "lu/profile", chunk=20, chunk_pivots=chunk_pivots,
        chunk_ms_per_pivot=f"{chunk_ms / chunk_pivots:.4f}",
        device_busy_ms_per_pivot=f"{busy_ms:.4f}" if busy_ms else "not measured",
        kernel_launches_per_pivot=f"{launches / chunk_pivots:.1f}",
        top_kernels=";".join(f"{name}:{ms:.4f}ms" for name, ms in top),
    )


def phase_other_modes(torch, np, device, knap6_pivots):
    """The other solve modes, each path's launch counts from 0 just before
    it and read just after it; then mip/real's kernels against their plain
    versions on the inputs that path gave them (launches not counted).
    Returns ({path: launches by kernel}, {kernel: mip/real's error})."""
    by_path, replays = {}, {}
    for path, run in (
        ("mip/small", lambda: phase_mip_small(knap6_pivots)),
        ("mip/real", lambda: phase_mip_real(torch, np)),
        ("mip/real64", lambda: phase_mip_real64(torch, np)),
        ("first_order/real", lambda: phase_first_order_real(torch)),
        ("first_order/pdhg", lambda: phase_first_order_pdhg(torch, np, device)),
        ("lu/real", lambda: phase_lu_real(torch)),
    ):
        _zero_launch_counts()
        replays[path] = run()
        by_path[path] = _launch_counts()
        _line("launches", path=path, **by_path[path])
    for path in ("mip/small", "mip/real", "mip/real64"):
        _check(by_path[path]["fused_price_scan"] > 0,
               f"{path} never launched the scan kernel")
    return by_path, replays["mip/real"]()


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
    knap6_pivots = phase_main_small(torch)
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

    by_path, mip_errors = phase_other_modes(torch, np, device, knap6_pivots)
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
        "mip_real_abs_err": mip_errors["fused_price_scan"],
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
            "mip_real_abs_err": mip_errors[fn],
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
    for entry in kernels:
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in by_path.items()}
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
