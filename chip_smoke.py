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
                   batched-pivot kernels at the families' shapes and of the
                   probe's two products);
  3. kernel        fused_price_scan against fused_price_scan_reference at
                   the node-LP class's small shapes, 1024 x 5120 and the
                   main path's shape, in f32, f64 and bf16 (two launches
                   bitwise equal), with CUDA-graph times warm and L2-cold,
                   the bound and its shares, and torch.matmul(P, A) (TF32
                   off, the product without the d/gamma epilogue) as
                   yardstick in the same L2 state, beside the card's name
                   and power limit;
  4. probe         the precision probe (relp_tpu_torch.tools.
                   probe_dot_precision): single-pass TF32 above 1e-6
                   relative error, 3xTF32 and the outer product within it;
                   each kernel against its plain version on the card at
                   M = 64, 256, 512 (1e-6 * max|plain|, the outer product
                   bitwise, also at 1,920, 4,096 and on edge values), two
                   launches bitwise equal; CUDA-graph times beside the
                   plain version's, the bound, a library call and the
                   empty kernel's (floor_ms); the outer product's times
                   warm and L2-cold at 256, 1,920 and 4,096 beside
                   torch.outer's, the bound and its shares;
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
                   DenseEngine's chunks replayed from CUDA graphs
                   (graphs=captures/replays/capture seconds), peak device
                   memory; then the scan kernel against its plain version
                   on the inputs of its first scan, timed (main/real/kernel);
                   then main/real/eager: the same solve with the chunks
                   eager, which must give the same pivots, basis and scan
                   launches (main/real/graph: the solve seconds and peak
                   memory of both);
  8. chunk         marginal per-pivot time of the chunk at the 1024 x 4096
                   bench problem: the eager run_chunk with the kernel and
                   with the plain version, and the chunk replayed from its
                   CUDA graph; each path's 60-pivot chunk under the
                   profiler (chunk/profile: device busy and idle share,
                   device kernels and host launches a pivot);
  8b. chunk/graph  from one state, an eager and a graphed chunk of each
                   kind (primal steepest edge, with stop_at_zero, in f64,
                   with a bf16 scan tableau, dual; the LU chunk from an
                   empty ring and from 7 etas, with stop_at_zero and with
                   Dantzig pricing; the df32 chunk; the PDHG chunk) at
                   1024 x 4096 and at 128 x 384: every output bitwise
                   equal, the capture's seconds, a replay's and the eager
                   chunk's ms;
  9. batch/resident, batch/blocked
                   solve_batch (default config) on the two scenario
                   families of relp_tpu_torch.testing (256 x 128x384 and
                   128 x 512x1408 lowered): every LP certified, the pinned
                   digest of the exact objectives, HiGHS on three scenarios,
                   the kernel of each family launched, peak device memory,
                   the wall split (device solve, certification) and the
                   steps' graphs (graphs=captures/replays/capture seconds,
                   from the process-wide cache of steps);
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
                   start, kernel path, plain path (the batched torch chunk,
                   eager) and the same chunk replayed from its CUDA graph,
                   at both family shapes, over a window in which every LP
                   pivots;
 12a. batch/graph  solve_batch's device steps at the families' shapes, each
                   eager and replayed from a CUDA graph from one state, then
                   once more from its output: _batch_step through each
                   batched-pivot kernel and on the batched torch path (f32,
                   f64 with f32 scans; with and without the stop at zero),
                   the warm family's dual chunk, the f64 polish chunk; the
                   whole state and the report bitwise equal, the kernels'
                   launches of a replay those of an eager step, the capture
                   seconds, a replay's and the eager step's ms.

The other solve modes follow, each with every kernel's launch count from 0
just before it (a `launches` line after each, with the captured chunks'
graphs=captures/replays/capture seconds of the path):

 12b. main/bf16    main/real's LP with SolverConfig(scan_dtype="bfloat16"),
                   at full width, 12,000 pivots a rung at most: certified
                   with main/real's digest, HiGHS within 1e-6; pivots,
                   escalations and each rung, chunk exits, scan launches by
                   dtype (bf16 launches required), the wall split; its scan
                   replayed on its first bf16 inputs after the path's
                   launches are read (main/bf16/kernel);

 13. mip/small     knap6 through the CLI with --mip, --first-order,
                   --basis-inverse lu, and that with --pricing dantzig (a
                   pivot's one BTRAN: eta_btran of one vector): exact -30,
                   certified; the MIP's best bound -30 and its incumbent
                   exactly feasible; the first-order crossover's warm
                   finish (fewer pivots than the cold solve);
 14. mip/real      solve_mip (f32 defaults: cuts, strong branching, dive;
                   64 nodes a wave, cut at 319 nodes) on the Chu-Beasley
                   knapsack of relp_tpu_torch.testing: a rigorous exact
                   best bound above the root LP's and no higher than
                   HiGHS's optimum, a stated minimum of node LPs solved in
                   the batch, an incumbent (if one is found) exactly
                   feasible and no better; nodes, batched solves,
                   fallbacks, the certification share, the nodes solved
                   before its first 64-wide wave that launched the blocked
                   kernel (blocked_wave_after_nodes).  After its launch
                   counts are read, each kernel is held against its plain
                   version on the inputs this path gave it (mip/kernel);
 15. mip/real64    the same knapsack with --dtype float64 and 16 nodes a
                   wave to a certified optimum: HiGHS's, an exactly
                   feasible incumbent, the waves in the batch; the split of
                   its wall (device solve, certification, B&B host) and
                   its graphs; its first scan of each dtype replayed and
                   timed (mip64/kernel);
 15a. mip/real64/eager
                   the same search with every step and chunk eager, cut at
                   400 nodes (about a fifth): its LP solves, call by call,
                   mip/real64's (each call's statuses, bases and pivots by
                   digest; the cut's narrower wave apart), the seconds of
                   those calls eager and graphed;
 16. first_order/real
                   solve_first_order (PDHG cut at 20,000 iterations) on
                   main/real's LP: certified, the pinned digest; PDHG
                   statistics, crossover pivots (a cold finish: the
                   crossover basis is refused), wall split;
 17. first_order/pdhg
                   pdhg_solve on a 2048 x 8192 LP (f32 A of 67 MB), its
                   chunks replayed from a CUDA graph, then eager: the same
                   point bit for bit; iterations/s and ms an iteration of
                   both, the device time per iteration of one chunk,
                   replayed and eager, against two reads of A, the KKT
                   residuals of the returned point in f64 on the host
                   against the card's, and its primal residual against the
                   same call's in f64 on the CPU
                   (relp_tpu_torch.tools.pdhg_check);
 18. lu/real, lu/split, lu/profile, lu/real/eager, lu/kernel
                   main/real's LP on the LU engine, its chunks replayed from
                   CUDA graphs (one capture for every fill of the eta ring,
                   whose passes are the eta-ring kernels' launches):
                   certified, the pinned digest, ms per pivot; the solve's
                   seconds split into chunk replays and chunk exits
                   (refactorizations, gamma refreshes, the rest); one chunk
                   of it replayed under the profiler for device kernels,
                   host launches and device-busy time per pivot; then the
                   same solve with eager chunks up to its 20th chunk, which
                   it must enter with the graphed run's state, bit for bit.
                   lu/solve: one _lu_solve at the path's M under the
                   profiler with shapes and stacks, adjoint False and
                   True: the op that launches torch's strided
                   _elementwise_kernel<128, 8, ...>, its operand's shape
                   and strides, and its launches a pivot.
                   After the paths' launches are read, lu/kernel: that 20th
                   chunk run eagerly once more, and eta_ftran and the
                   BTRAN pair (eta_btran_pair; also eta_btran, one vector,
                   on the pair's first) on the inputs of every call against
                   their plain versions (the plain FTRAN loop and the
                   ordered BTRAN twin), bit for bit; on the first and the
                   last call each timed warm and L2-cold and at no live
                   slot, beside the slot-chain probe (a pass that makes the
                   whole vector wait on each slot: the live slots' L2 reads
                   and barriers alone), the torch loops over the live slots
                   replayed from a graph, and the bound; the text line also
                   shows the one-block design's times as PERF.md records
                   them (not measured in the run).
 19. df32/real, df32/profile, df32/real/eager, df32/kernel
                   main/real's LP with the double-float carry
                   (carry="df32"), its chunks replayed from CUDA graphs:
                   certified by that rung, the pinned digest, scan
                   launches, ms per pivot, the certification share; one
                   chunk replayed under the profiler; the eager prefix as
                   for lu/real; then the
                   scan kernel against its plain version on this path's
                   inputs, and df_matvec/df_vecmat on the card against the
                   CPU on the same f32 inputs, bitwise, at M = 1920.
 20. mesh/world1, mesh/chunk, mesh/kernel
                   the mesh as a world of one over NCCL
                   (initialize_multihost(), make_mesh((1, 1))), every loop
                   replayed from CUDA graphs with its collectives captured:
                   main/real through solve_relaxation(mesh=...) with
                   main/real's basis, pivots and digest, a replay a chunk;
                   the resident family through solve_batch(mesh=...) on the
                   batched torch path, three times (the second call
                   captures what the first took once, the third only
                   replays), its digest and the same bases;
                   first_order/pdhg's LP through pdhg_solve(mesh=...) held
                   to the same call unsharded (4,000 iterations; that call,
                   like the chunk-loop timing below, runs outside the
                   path's launch count) and, bit for bit, to itself with
                   its chunks eager; collectives and ms per pivot of the
                   sharded chunk loop, eager and replayed from a graph (the
                   same bits, the same collectives a pivot), beside the
                   unsharded one (also timed before the process group
                   exists); the scan kernel against its plain version on
                   this path's inputs.  One card shows the code, not a
                   scale-out.
 21. mesh/lu       in the same NCCL world of one, before it is destroyed:
                   main/real's LP on the LU engine through
                   solve_relaxation(mesh=..., basis_inverse="lu"), its
                   chunks replayed from graphs, cut to the prefix before
                   its 20th chunk: lu/real's pivots, basis and status there
                   exactly; collectives and ms per pivot of the prefix
                   beside lu/real's, and its seconds split as lu/split's
                   (mesh/lu/split); the 20th chunk's graph replayed under
                   the profiler for launches, host launches and
                   device-busy time per pivot beside lu/real's.

A `[time] phase=<name> s=<seconds>` line follows every phase (a phase run
inside another, mesh/lu, is not counted twice), and `[time] total_s=...`
the last of them.  Then a JSON line describing each kernel (eight: the
scan, the two batched-pivot kernels, the probe's three and the two
eta-ring kernels, BTRAN's timed as the pair) with its time, its plain
version's, its bound (the larger of its bytes at 3.35 TB/s and its
operations at the H100's peak for their type), the library yardstick,
its error on mip/real's inputs (the scan's also on main/real's,
main/bf16's, mip/real64's, df32/real's and mesh/world1's, with its times
there and at every shape of phase 3) and its launches on each of the paths
12b-21 (the scan's also by dtype; the probe's three also floor_ms and
repeat_bitwise), and as the
last line {"ok":
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


# Seconds of the phases that have ended, for _timed's nesting.
_ENDED_S = [0.0]


def _timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then a ``[time] phase=<name> s=<seconds>``
    line: the phase's own seconds, a phase timed inside it not counted
    again, so that the lines add up to the script's wall time."""
    ended0 = _ENDED_S[0]
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    elapsed = time.perf_counter() - t0
    print(f"[time] phase={name} s={elapsed - (_ENDED_S[0] - ended0):.1f}", flush=True)
    _ENDED_S[0] = ended0 + elapsed
    return out


# The card's name and power limit as nvidia-smi gives them, for the lines
# that carry a time.
_CARD = {}


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
    name, limit = (part.strip() for part in smi.split(",", 1))
    _CARD.update(card=repr(name), power_limit=repr(limit))
    _line(
        "device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, matmul_precision="highest", tf32=False,
    )
    return device


def phase_build():
    from relp_tpu_torch.ops import _build, batch_pivot, price_scan
    from relp_tpu_torch.tools import probe_dot_precision

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
    for kind, split in (("tf32", "false"), ("tf32x3", "true")):
        _line("build", kernel=f"probe_mma_kernel<{split}>",
              dynamic_smem_bytes=probe_dot_precision.smem_bytes(kind))
    M, N = main_path_shape()
    for name, itemsize in (("float32", 4), ("float64", 8), ("bfloat16", 2)):
        t = price_scan.tiling(M, N, itemsize)
        _line("build", kernel=f"price_scan_kernel<{name}>", shape=f"{M}x{N}",
              tiling=",".join(map(str, t)), ctas=-(-N // t.tile_cols) * t.cluster,
              dynamic_smem_bytes=price_scan.smem_bytes(itemsize, t))


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
    larger than L2), each call follows a read of all of it (a sum), so the
    call finds its inputs in device memory and L2 holds only clean lines (a
    write would leave dirty ones, whose write-back the call would pay for),
    and the time of the reads alone is taken off."""
    total = torch.empty((), dtype=flush.dtype, device=flush.device) if flush is not None else None

    def flushes():
        for _ in range(calls):
            torch.sum(flush, dim=0, out=total)

    def body():
        for _ in range(calls):
            if flush is not None:
                torch.sum(flush, dim=0, out=total)
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
    gamma finite and within tol * (1 + max|plain|), and a second launch
    bitwise equal to the first.  Returns (the largest absolute error,
    "d:rel,gamma:rel")."""
    from relp_tpu_torch.ops import price_scan

    outs_k = price_scan.fused_price_scan(P, A, c, gamma, gamma_q)
    again = price_scan.fused_price_scan(P, A, c, gamma, gamma_q)
    outs_p = price_scan.fused_price_scan_reference(P, A, c, gamma, gamma_q)
    torch.cuda.synchronize()
    worst, errs = 0.0, []
    for name, kern, second, plain in zip(("d", "gamma"), outs_k, again, outs_p):
        _check(torch.equal(kern.view(torch.uint8), second.view(torch.uint8)),
               f"{label}: two launches give other bits of {name}")
        kern64, plain64 = kern.double(), plain.double()
        _check(bool(torch.isfinite(kern64).all()), f"{label}: non-finite {name}")
        err = float((kern64 - plain64).abs().max())
        scale = float(plain64.abs().max())
        _check(err <= tol * (1.0 + scale),
               f"{name} at {label}: |err| {err:.3e} > {tol:g} * (1 + {scale:.3e})")
        worst = max(worst, err)
        errs.append(f"{name}:{err / (1.0 + scale):.3e}")
    return worst, ",".join(errs)


# |err| <= tol * (1 + max|plain|) by the tableau's dtype: f32 and f64 differ
# from the plain version only by summation order; bf16 rounds S and every
# output to 8 bits in both, at other places.
SCAN_TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 5e-2}


def scan_cases(main_shape):
    """(M, N, dtype name) of the kernel phase: small shapes of the node-LP
    class, the chunk loop's 1024 x 5120 and the main path's shape, in f32,
    f64 and bf16."""
    return [
        (8, 128, "float32"), (96, 1280, "float32"), (100, 1000, "float32"),
        (128, 384, "float32"), (1024, 5120, "float32"), (*main_shape, "float32"),
        (384, 1920, "float64"), (1024, 5120, "float64"), (*main_shape, "float64"),
        (96, 1280, "bfloat16"), (1024, 5120, "bfloat16"), (*main_shape, "bfloat16"),
    ]


def _scan_inputs(torch, np, device, M, N, dtype):
    """(P, A, c, gamma, gamma_q) of an (M, N) scan, from a seed of the shape."""
    rng = np.random.default_rng(M * 7919 + N)
    as_t = lambda x: torch.as_tensor(x, device=device).to(dtype)  # noqa: E731
    return (as_t(rng.standard_normal((3, M))), as_t(rng.standard_normal((M, N))),
            as_t(rng.standard_normal(N)), as_t(1.0 + np.abs(rng.standard_normal(N))),
            as_t(1.0 + abs(float(rng.standard_normal())) * 5))


_FLUSH = []


def _flush(torch):
    """128 MB to read between calls: it evicts any tableau from the 50 MB L2."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(32 * 2**20, dtype=torch.float32, device="cuda"))
    return _FLUSH[0]


def _time_scan(torch, args):
    """Device ms of the scan kernel, its plain version and torch.matmul(P, A)
    (TF32 off, the product without the d/gamma epilogue) on ``args``, warm
    and L2-cold (each call after a flush of L2), and the bound: A, P, c and
    gamma read once, d and gamma written, 6 M N operations."""
    from relp_tpu_torch.ops import price_scan

    P, A = args[0], args[1]
    M, N = A.shape
    calls = {
        "kernel": lambda: price_scan.fused_price_scan(*args),
        "plain": lambda: price_scan.fused_price_scan_reference(*args),
        "matmul": lambda: torch.matmul(P, A),
    }
    out = {"shape": f"{M}x{N}", "dtype": str(A.dtype).replace("torch.", "")}
    for name, fn in calls.items():
        out[f"{name}_ms"] = _graph_ms(torch, fn)
        out[f"{name}_cold_ms"] = _graph_ms(torch, fn, flush=_flush(torch))
    out["bound_ms"], out["bound_by"] = _bound(
        (M * N + 3 * M + 4 * N) * A.element_size(), 6.0 * M * N,
        F64_FLOPS if A.dtype == torch.float64 else F32_FLOPS)
    return out


def _scan_fields(t):
    """A scan line's times: the kernel's, the plain version's and the
    library call's, warm and L2-cold; the bound and its shares (the warm one
    of a tableau that L2 holds); the kernel against the library call; the
    card."""
    return dict(
        kernel_ms=f"{t['kernel_ms']:.5f}", kernel_cold_ms=f"{t['kernel_cold_ms']:.5f}",
        plain_ms=f"{t['plain_ms']:.5f}", plain_cold_ms=f"{t['plain_cold_ms']:.5f}",
        matmul_ms=f"{t['matmul_ms']:.5f}", matmul_cold_ms=f"{t['matmul_cold_ms']:.5f}",
        bound_ms=f"{t['bound_ms']:.5f}", bound_by=t["bound_by"],
        bound_share_cold=f"{t['bound_ms'] / t['kernel_cold_ms']:.3f}",
        bound_share_warm_l2_resident=f"{t['bound_ms'] / t['kernel_ms']:.3f}",
        kernel_over_matmul=f"{t['kernel_ms'] / t['matmul_ms']:.3f}",
        kernel_over_matmul_cold=f"{t['kernel_cold_ms'] / t['matmul_cold_ms']:.3f}",
        **_CARD,
    )


def _replay_scan(torch, label, args):
    """The scan kernel against its plain version on the inputs a path gave
    it (``_hold_scan``, the tolerance of its dtype), timed as the kernel
    phase times it; one line.  Returns (the largest absolute error, the
    times)."""
    dtype = str(args[1].dtype).replace("torch.", "")
    err, errs = _hold_scan(torch, label, SCAN_TOL[dtype], *args)
    t = _time_scan(torch, args)
    _line(label, kernel="fused_price_scan", shape="x".join(map(str, args[1].shape)),
          dtype=dtype, rel_err=errs, tol=f"{SCAN_TOL[dtype]:g}*(1+scale)",
          repeat_bitwise=True, **_scan_fields(t))
    return err, t


def phase_kernel(torch, np, device):
    from relp_tpu_torch.ops import price_scan

    main_shape = main_path_shape()
    errors, times = {}, {}
    for M, N, name in scan_cases(main_shape):
        dtype, tol = getattr(torch, name), SCAN_TOL[name]
        args = _scan_inputs(torch, np, device, M, N, dtype)
        errors[(M, N, dtype)], errs = _hold_scan(torch, f"{M}x{N} {name}", tol, *args)
        t = times[(M, N, dtype)] = _time_scan(torch, args)
        tableau_gb = M * N * args[1].element_size() / 1e9
        _line(
            "kernel", shape=f"{M}x{N}", dtype=name, rel_err=errs,
            tol=f"{tol:g}*(1+scale)", repeat_bitwise=True,
            tiling=",".join(map(str, price_scan.tiling(M, N, args[1].element_size()))),
            **_scan_fields(t),
            kernel_GBps=f"{tableau_gb / (t['kernel_ms'] * 1e-3):.1f}",
            kernel_cold_GBps=f"{tableau_gb / (t['kernel_cold_ms'] * 1e-3):.1f}",
        )
    return main_shape, errors, times


PROBE_SIZES = (64, 256, 512)
# The outer product is also held at main/real's basis dimension (the shape
# of a rank-1 update of its (1920, 1920) inverse) and where C (67.1 MB)
# outgrows L2, and timed at the probe's shape and at those two.
OUTER_SIZES = (1920, 4096)
OUTER_TIMED = (256, 1920, 4096)
# The edge values go through the outer kernel at the smallest grid and at
# the largest, four rows a thread over four chunks of a row.
OUTER_EDGE_SIZES = (64, 4096)


def phase_probe(torch, device):
    """The precision probe's main path (relp_tpu_torch.tools.
    probe_dot_precision.run, M=256) with its launch counts from 0 and its
    bands against the exact product.  Then, at each of PROBE_SIZES, every
    kernel against its plain version run on the card
    (probe_dot_reference): the two products within 1e-6 * max|plain| (the
    kernel sums the same TF32 terms in f32, the plain version in f64: f32
    summation order over K <= 512), the outer product bitwise (the same
    f32 multiplies, also at OUTER_SIZES and on the edge values of
    probe.EDGE_BITS at OUTER_EDGE_SIZES, NaN by position); and two launches on the same inputs
    bitwise equal.
    At M=256 each kernel's time beside its plain version's on the card,
    its bound, a library call (torch.matmul with TF32 allowed for tf32,
    torch.matmul in full f32 for tf32x3: the same product by another
    method, torch.outer for outer) and floor_ms: the empty kernel of the
    same source, timed the same way, the part of every time that no design
    of a kernel's body removes.  At each of OUTER_TIMED the outer kernel's
    time warm and L2-cold (each call after a 128 MB read) beside
    torch.outer's in the same state, the bound and its shares, and
    floor_ms (at 1,920 C's 14.7 MB stays in L2 between warm calls, so the
    warm share may pass 1: the cold one is the yardstick)."""
    from relp_tpu_torch.tools import probe_dot_precision as probe

    for kind in probe.KINDS:
        probe.LAUNCHES[kind] = 0
    rel = probe.run(device)
    launches = dict(probe.LAUNCHES)
    _check(1e-6 < rel["tf32"] < 1e-2, f"probe tf32 error {rel['tf32']:.3e}")
    _check(rel["tf32x3"] <= 1e-6 and rel["outer"] <= 1e-6,
           f"probe errors {rel}")
    vs_plain, repeat = {}, {kind: True for kind in probe.KINDS}
    for M in PROBE_SIZES + OUTER_SIZES:
        a, b = probe.inputs(device, M)
        for kind in probe.KINDS if M in PROBE_SIZES else ("outer",):
            first, second = probe.probe_dot(kind, a, b), probe.probe_dot(kind, a, b)
            plain = probe.probe_dot_reference(kind, a, b)
            torch.cuda.synchronize()
            err = float((first.double() - plain).abs().max())
            scale = float(plain.abs().max())
            bitwise = torch.equal(first, second)
            tol = 0.0 if kind == "outer" else 1e-6 * scale
            _check(err <= tol, f"probe {kind} at M={M}: |kernel - plain| {err:.3e} > {tol:.3e}")
            _check(bitwise, f"probe {kind} at M={M}: two launches differ")
            vs_plain[kind, M] = err
            repeat[kind] &= bitwise
            _line("probe", kind=kind, shape=f"{M}x{M}", vs_plain=f"{err / scale:.3e}",
                  tol="0" if kind == "outer" else "1e-6*max|plain|", repeat_bitwise=bitwise)
    for M in OUTER_EDGE_SIZES:
        a, b = probe.edge_inputs(device, M)
        first, second = probe.probe_dot("outer", a, b), probe.probe_dot("outer", a, b)
        plain = probe.probe_dot_reference("outer", a, b).to(torch.float32)
        bits, again = probe.same_bits(first, plain), probe.same_bits(second, first)
        _check(bits and again,
               f"probe outer on the edge values at M={M}: bitwise={bits} repeat={again}")
        repeat["outer"] &= again
        _line("probe", kind="outer", shape=f"{M}x{M}", inputs="edge",
              values=len(probe.EDGE_BITS), nan=int(torch.isnan(plain).sum()), bitwise=bits,
              repeat_bitwise=again)
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
    floor_ms = _graph_ms(torch, lambda: probe.empty_launch(device))
    out = {}
    for kind in probe.KINDS:
        ms = _graph_ms(torch, lambda: probe.probe_dot(kind, a, b))
        plain_ms = _graph_ms(torch, lambda: probe.probe_dot_reference(kind, a, b))
        torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
        try:
            library_ms = _graph_ms(torch, library[kind])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out[kind] = dict(launches=launches[kind], max_abs_err=vs_plain[kind, M], ms=ms,
                         plain_ms=plain_ms, bound_ms=bounds[kind][0],
                         bound_by=bounds[kind][1], library_ms=library_ms,
                         floor_ms=floor_ms, repeat_bitwise=repeat[kind])
        _line("probe", kind=kind, shape=f"{M}x{M}", rel_err=f"{rel[kind]:.3e}",
              launches=launches[kind], kernel_ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
              library_ms=f"{library_ms:.5f}", bound_ms=f"{bounds[kind][0]:.5f}",
              bound_by=bounds[kind][1], floor_ms=f"{floor_ms:.5f}")
    shapes = {}
    for M in OUTER_TIMED:
        a, b = probe.inputs(device, M)
        t = {}
        for state, flush in (("warm", None), ("cold", _flush(torch))):
            t[f"{state}_ms"] = _graph_ms(torch, lambda: probe.probe_dot("outer", a, b),
                                         flush=flush)
            t[f"library_{state}_ms"] = _graph_ms(
                torch, lambda: torch.outer(a[:, 0], b[0, :]), flush=flush)
        bound_ms, bound_by = _bound((2 * M + M * M) * 4, 1.0 * M * M, F32_FLOPS)
        shapes[M] = dict(t, bound_ms=bound_ms, bound_by=bound_by)
        _line("probe", kind="outer", shape=f"{M}x{M}", **_CARD,
              **{k: f"{v:.5f}" for k, v in t.items()}, bound_ms=f"{bound_ms:.5f}",
              bound_by=bound_by, share_warm=f"{bound_ms / t['warm_ms']:.3f}",
              share_cold=f"{bound_ms / t['cold_ms']:.3f}", floor_ms=f"{floor_ms:.5f}")
    out["outer"]["cold_ms"] = shapes[256]["cold_ms"]
    out["outer"]["at_shapes"] = {f"{M}x{M}": v for M, v in shapes.items()}
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


# main/bf16's iteration limit (a rung's pivots).  Its f32 rung stalls on
# the card (PERF.md): uncapped it ran about 62,000 pivots (890 s) before
# the f64 rung certified in 8,017; capped, the f64 rung certified in 8,986.
# main/real takes 4,260.  The cap ends the stalled rung within the script's
# 1,200 s and leaves the f64 rung a third more pivots than it took.
_MAIN_BF16_MAX_ITERATIONS = 12_000


@contextlib.contextmanager
def _recording_rungs(rungs):
    """Each rung of the escalation ladder that solve_relaxation runs, as
    "dtype:status:certified:pivots:seconds" in ``rungs``."""
    from relp_tpu_torch.simplex import driver

    def wrapper(once):
        def run(provider, cfg, *args, **kwargs):
            t0 = time.perf_counter()
            result = once(provider, cfg, *args, **kwargs)
            rungs.append(f"{cfg.dtype}:{result.status.value}:{result.stats.certified}:"
                         f"{result.stats.iterations}:{time.perf_counter() - t0:.1f}")
            return result
        return run

    with _wrapped(driver, "_solve_relaxation_once", wrapper):
        yield


def phase_main_real(torch, np, label="main/real", scan_dtype="float32", main_result=None,
                    **limits):
    """main/real's LP through solve_general_form with SolverConfig(scan_dtype=
    ``scan_dtype``, **limits), everything else the defaults: certified, the
    pinned exact-objective digest, HiGHS agreement to 1e-6; pivots, chunk
    exits, escalations and each rung, scan launches by dtype, the wall
    split.  The inputs of the first scan of the tableau in ``scan_dtype``
    are kept.  Returns the result and the replay of the kernel against its
    plain version on them (run once the path's launches are read)."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.ops import price_scan
    from relp_tpu_torch.simplex import SolveStatus, kernels, solve_general_form
    from relp_tpu_torch.testing import (
        REAL_SIZE,
        REAL_SIZE_OBJECTIVE_SHA256,
        generated_lp,
    )

    gf = generated_lp(**REAL_SIZE)
    kept, rungs = {}, []
    scans = getattr(torch, scan_dtype)
    with _keeping_inputs(kernels, "fused_price_scan", kept,
                         when=lambda _P, A, *_rest: A.dtype == scans), \
            _recording_rungs(rungs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        graphs0, launches0 = _graph_counts(), price_scan.LAUNCHES
        t0 = time.perf_counter()
        result, solution = solve_general_form(
            gf, SolverConfig(scan_dtype=scan_dtype, **limits))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graph_counts = {k: v - graphs0[k] for k, v in _graph_counts().items()}
    _SOLVES[label] = dict(result=result, scan_launches=price_scan.LAUNCHES - launches0,
                          peak_mb=torch.cuda.max_memory_allocated() / 2**20,
                          solve_s=result.stats.wall_time_s - result.stats.certify_time_s)
    by_dtype = dict(price_scan.LAUNCHES_BY_DTYPE)
    _check(result.status is SolveStatus.FINITE_OPTIMUM, f"{label}: status {result.status}")
    _check(result.stats.certified, f"{label}: not certified")
    digest = hashlib.sha256(str(solution.objective_value).encode()).hexdigest()
    _check(digest == REAL_SIZE_OBJECTIVE_SHA256, f"{label}: objective digest {digest}")
    objective = float(solution.objective_value)
    if "real" not in _HIGHS:
        _HIGHS["real"] = _highs_objective(np)
    highs = _HIGHS["real"]
    rel = abs(objective - highs) / max(1.0, abs(highs))
    _check(rel <= 1e-6, f"{label}: HiGHS {highs} vs {objective}")
    _check("fused_price_scan" in kept, f"{label}: no scan of the {scan_dtype} tableau")
    _line(
        label, m=REAL_SIZE["m"], n=REAL_SIZE["n"], seed=REAL_SIZE["seed"],
        scan_dtype=scan_dtype, status=result.status.value, certified=result.stats.certified,
        pivots=result.stats.iterations, phase1_pivots=result.stats.phase1_iterations,
        **({} if main_result is None else
           {"main_real_pivots": main_result.stats.iterations}),
        escalations=",".join(result.stats.escalations) or "none",
        rungs=",".join(rungs), **limits,
        refactorizations=result.stats.refactorizations, chunks=result.stats.chunks,
        wall_s=f"{wall:.3f}", solve_wall_s=f"{result.stats.wall_time_s:.3f}",
        solve_s=f"{result.stats.wall_time_s - result.stats.certify_time_s:.3f}",
        certify_s=f"{result.stats.certify_time_s:.3f}",
        objective=f"{objective:.12f}", digest_ok=True, highs_rel_diff=f"{rel:.2e}",
        price_scan_launches=price_scan.LAUNCHES,
        solve_scan_launches=_SOLVES[label]["scan_launches"],
        **{f"scan_launches_{name}": n for name, n in by_dtype.items()},
        graphs=_graph_fields(graph_counts),
        peak_device_mb=f"{_SOLVES[label]['peak_mb']:.1f}",
        peak_reserved_mb=f"{torch.cuda.max_memory_reserved() / 2**20:.1f}",
    )
    return result, lambda: _replay_scan(torch, f"{label}/kernel", kept["fused_price_scan"][0])


# The single-LP solves of main/real and main/real/eager: result, the scan
# launches of the solve alone, peak device MB, seconds of the solve without
# certification.
_SOLVES = {}


def _graph_counts():
    """The captured chunks' counters (relp_tpu_torch.simplex.graphs)."""
    from relp_tpu_torch.simplex import graphs

    return {"captures": graphs.CAPTURES, "replays": graphs.REPLAYS,
            "capture_s": graphs.CAPTURE_SECONDS, "evictions": graphs.EVICTIONS}


def _graph_fields(counts):
    """captures/replays/capture seconds (the warm-up included)."""
    return f"{counts['captures']}/{counts['replays']}/{counts['capture_s']:.2f}"


def phase_main_real_eager(torch, np, main_result):
    """main/real again with DenseEngine's chunks eager (graphs.DEVICE_TYPES
    emptied for the phase): the same pivots, digest and scan launches as the
    graphed solve, its wall split and peak device memory beside them."""
    from relp_tpu_torch.simplex import graphs

    kept = graphs.DEVICE_TYPES
    graphs.DEVICE_TYPES = ()
    try:
        result, _replay = phase_main_real(torch, np, "main/real/eager",
                                          main_result=main_result)
    finally:
        graphs.DEVICE_TYPES = kept
    graphed, eager = _SOLVES["main/real"], _SOLVES["main/real/eager"]
    _check(result.stats.iterations == main_result.stats.iterations
           and result.basis == main_result.basis,
           f"main/real/eager: {result.stats.iterations} pivots, graphed "
           f"{main_result.stats.iterations}, same basis {result.basis == main_result.basis}")
    _check(eager["scan_launches"] == graphed["scan_launches"],
           f"main/real/eager: {eager['scan_launches']} scan launches, graphed "
           f"{graphed['scan_launches']}")
    _line("main/real/graph", pivots=result.stats.iterations, same_pivots=True,
          same_basis=True,
          scan_launches=graphed["scan_launches"], eager_scan_launches=eager["scan_launches"],
          solve_s=f"{graphed['solve_s']:.3f}", eager_solve_s=f"{eager['solve_s']:.3f}",
          peak_device_mb=f"{graphed['peak_mb']:.1f}",
          eager_peak_device_mb=f"{eager['peak_mb']:.1f}", **_CARD)


def _bench_chunk_inputs(torch, np, device):
    """(state0, A, c, mask) of the chunk loop's bench problem on the card:
    testing.synthetic_problem(m=1024, n=4096, pad=128, seed=7), f32,
    phase-1 costs, the slack/artificial start."""
    from relp_tpu_torch.testing import synthetic_start

    state0, A, c1, _c2, cand = synthetic_start(m=1024, n=4096, pad=128, seed=7,
                                               dtype=np.float32, device=device)
    return state0, A, c1, cand


def _marginal_ms_per_pivot(torch, np, runs, reps: int = 8):
    """{path: (median, q1, q3 ms per pivot, pivots of the long run)}:
    ``runs[path](chunk)`` returns
    (seconds, pivots) with a host read of the pivot count inside the timed
    region; the (300 - 10)-pivot difference, paths interleaved, after one
    warm-up of each."""
    chunks = (10, 300)
    for run in runs.values():
        for chunk in chunks:
            run(chunk)
    estimates = {path: [] for path in runs}
    pivots = {}
    for rep_i in range(reps):
        order = list(runs) if rep_i % 2 == 0 else list(runs)[::-1]
        for path in order:
            t_small, i_small = runs[path](chunks[0])
            t_big, i_big = runs[path](chunks[1])
            pivots[path] = (i_small, i_big)
            _check(i_big > i_small, f"{path}: no pivots {i_small} {i_big}")
            estimates[path].append((t_big - t_small) / (i_big - i_small))
    return {p: (float(np.median(v)) * 1e3,
                *(float(q) * 1e3 for q in np.percentile(v, [25, 75])), pivots[p][1])
            for p, v in estimates.items()}


def phase_chunk_loop(torch, np, device, times):
    """The chunk loop at the bench problem, three paths interleaved: the
    eager chunk with the kernel (``kernel``) and with the plain version
    swapped in (``plain``), and the chunk captured as a CUDA graph and
    replayed (``graph``, simplex/graphs.py, as DenseEngine runs it); then
    a 60-pivot chunk of the kernel and graph paths under the profiler."""
    from relp_tpu_torch.ops import price_scan
    from relp_tpu_torch.simplex import graphs, kernels

    state0, A_d, c_d, cand_d = _bench_chunk_inputs(torch, np, device)
    M, N = A_d.shape
    captured = graphs.ChunkGraphs()
    kw = dict(pricing=kernels.PRICE_STEEPEST, opt_tol=1e-7, pivot_tol=1e-7,
              degen_tol=1e-7)

    def run(chunk, graph=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn = captured.run_chunk if graph else kernels.run_chunk
        out = fn(state0, A_d, A_d, c_d, cand_d, chunk=chunk, **kw)
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

    def with_scan(path):
        def timed(chunk):
            if path == "graph":
                return run(chunk, graph=True)
            with scan(path):
                return run(chunk)
        return timed

    per_pivot = _marginal_ms_per_pivot(
        torch, np, {path: with_scan(path) for path in ("kernel", "plain", "graph")})
    scan = times[(1024, 5120, torch.float32)]
    kern_ms, plain_ms = scan["kernel_ms"], scan["plain_ms"]
    _line(
        "chunk", shape=f"{M}x{N}", dtype="float32", pricing="steepest",
        method="median of 8 interleaved (300-10)-pivot differences",
        pivots=per_pivot["kernel"][3],
        kernel_path_ms_per_pivot=f"{per_pivot['kernel'][0]:.4f}",
        plain_path_ms_per_pivot=f"{per_pivot['plain'][0]:.4f}",
        graph_path_ms_per_pivot=f"{per_pivot['graph'][0]:.4f}",
        graph_path_pivots=per_pivot["graph"][3],
        kernel_path_q1_q3="/".join(f"{q:.4f}" for q in per_pivot["kernel"][1:3]),
        plain_path_q1_q3="/".join(f"{q:.4f}" for q in per_pivot["plain"][1:3]),
        graph_path_q1_q3="/".join(f"{q:.4f}" for q in per_pivot["graph"][1:3]),
        scan_kernel_ms=f"{kern_ms:.5f}", scan_plain_ms=f"{plain_ms:.5f}", **_CARD,
    )
    _check(per_pivot["graph"][3] == per_pivot["kernel"][3],
           f"chunk: the graph path took {per_pivot['graph'][3]} pivots, the "
           f"kernel path {per_pivot['kernel'][3]}")
    run(60, graph=True)  # captures the 60-pivot chunk: the profile reads a replay
    for path in ("kernel", "graph"):
        busy_ms, launches, top, host = _device_busy(
            torch, lambda: run(60, graph=path == "graph"), 60)
        # The profiler's kernel durations can sum above the unprofiled
        # wall time (it traces every node of a graph): no idle share then.
        busy_over_wall = busy_ms / per_pivot[path][0]
        _line(
            "chunk/profile", path=path, pivots=60,
            device_busy_ms_per_pivot=f"{busy_ms:.4f}" if busy_ms else "not measured",
            wall_ms_per_pivot=f"{per_pivot[path][0]:.4f}",
            busy_over_wall=f"{busy_over_wall:.3f}",
            device_idle_share=(f"{1.0 - busy_over_wall:.3f}" if 0 < busy_over_wall <= 1
                               else "not measured"),
            kernel_launches_per_pivot=f"{launches / 60:.1f}",
            host_launches_per_pivot=f"{sum(host.values()) / 60:.3f}",
            host_launches=";".join(f"{name}:{n}" for name, n in sorted(host.items())),
            top_kernels=";".join(f"{name}:{ms:.4f}ms" for name, ms in top),
        )


def phase_chunk_graph(torch, np, device):
    """From one state, one eager and one graphed chunk of each kind of
    testing.chunk_case (primal steepest edge, with stop_at_zero, in f64,
    with a bf16 scan tableau, dual) at the bench problem's 1024 x 4096 and
    at the node-LP shape 128 x 384, and of each kind of testing.body_case
    (the LU chunk from an empty ring and from 7 etas, with stop_at_zero and
    Dantzig pricing; the df32 chunk; the PDHG chunk on pdhg_lp at the same
    m x n): whether every output is bitwise equal, the pivots, the
    capture's seconds (warm-up included), a replay's ms and the eager
    chunk's ms (host clock, a sync at the end of each)."""
    from relp_tpu_torch.simplex import graphs, kernels
    from relp_tpu_torch.testing import BODY_KINDS, CHUNK_KINDS, chunk_case, synthetic_start

    differ = []
    for m, n in ((1024, 4096), (128, 256)):
        state, A, c1, _c2, mask = synthetic_start(m=m, n=n, pad=128, seed=7,
                                                  dtype=np.float32, device=device)
        for kind in CHUNK_KINDS:
            name, args, kw = chunk_case(kind, state, A, c1, mask)

            def timed(fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                return out, (time.perf_counter() - t0) * 1e3

            eager, eager_ms = timed(getattr(kernels, name))
            cache, capture_s = graphs.ChunkGraphs(), graphs.CAPTURE_SECONDS
            graphed, _first_ms = timed(getattr(cache, name))
            capture_s = graphs.CAPTURE_SECONDS - capture_s
            again, replay_ms = timed(getattr(cache, name))
            fields = [f for f, g, e, a in zip(eager._fields, graphed, eager, again)
                      if not (torch.equal(g.reshape(-1).view(torch.uint8),
                                          e.reshape(-1).view(torch.uint8))
                              and torch.equal(a.reshape(-1).view(torch.uint8),
                                              e.reshape(-1).view(torch.uint8)))]
            if fields:
                differ.append(f"{kind}@{tuple(A.shape)}:{','.join(fields)}")
            _line("chunk/graph", shape="x".join(map(str, A.shape)), kind=kind,
                  pivots=int(eager.iteration) - int(args[0].iteration),
                  bitwise_equal=not fields, differing_fields=",".join(fields) or "none",
                  capture_s=f"{capture_s:.3f}", replay_ms=f"{replay_ms:.3f}",
                  eager_ms=f"{eager_ms:.3f}", **_CARD)
        for kind in BODY_KINDS:
            differ += _hold_graphed_body(torch, device, kind, m, n)
    return differ


def _hold_graphed_body(torch, device, kind, m, n):
    """chunk/graph's line for one kind of testing.body_case (the LU, df32
    and PDHG chunks) at (m, n): an eager and a graphed chunk from one
    state, then a replay; returns ["kind@shape:fields"] if any differ."""
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import body_case

    start, eager_fn, graphed_fn = body_case(kind, m, n, pad=128, seed=7, device=device)
    cache = graphs.ChunkGraphs()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    eager, eager_ms = timed(lambda: eager_fn(start))
    capture_s = graphs.CAPTURE_SECONDS
    graphed, _first_ms = timed(lambda: graphed_fn(cache, start))
    capture_s = graphs.CAPTURE_SECONDS - capture_s
    again, replay_ms = timed(lambda: graphed_fn(cache, start))
    fields = [f for f, g, e, a in zip(eager._fields, graphed, eager, again)
              if not (torch.equal(g.reshape(-1).view(torch.uint8),
                                  e.reshape(-1).view(torch.uint8))
                      and torch.equal(a.reshape(-1).view(torch.uint8),
                                      e.reshape(-1).view(torch.uint8)))]
    rows, cols = (start.y, start.x) if kind == "pdhg" else (start.xB, start.in_basis)
    steps = (dict(iterations=60) if kind == "pdhg" else
             dict(pivots=int(eager.iteration) - int(start.iteration)))
    extra = dict(eta0=int(start.eta_count)) if kind.startswith("lu_") else {}
    _line("chunk/graph", shape=f"{rows.shape[0]}x{cols.shape[0]}", kind=kind, **steps,
          **extra, bitwise_equal=not fields, differing_fields=",".join(fields) or "none",
          capture_s=f"{capture_s:.3f}", replay_ms=f"{replay_ms:.3f}",
          eager_ms=f"{eager_ms:.3f}", **_CARD)
    return [f"{kind}@{m}x{n}:{','.join(fields)}"] if fields else []


def _device_busy(torch, fn, pivots: int):
    """torch.profiler over ``fn``: device milliseconds per pivot summed over
    the device's events (kernels, copies, sets), their count (the device
    kernels), the five costliest kernels by name, and {CUDA runtime or
    driver call: count} of the work the host handed the card (kernel and
    graph launches, copies, sets).  The raw Kineto events are read:
    building the profiler's Python events (``key_averages``) for a chunk of
    60,000 launches takes longer than the chunk itself."""
    from collections import Counter, defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    starts = ("cudaLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset", "cuLaunch",
              "cuGraphLaunch", "cuMemcpy", "cuMemset")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    by_name = defaultdict(float)
    launches = 0
    host = Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] += e.duration_ns() / 1e6
            launches += 1
        elif e.name().startswith(starts):
            host[e.name()] += 1
    busy_ms = sum(by_name.values()) / pivots
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:5]
    return busy_ms, launches, [(name[:100], ms / pivots) for name, ms in top], host


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
    counts = _graph_counts()
    t0 = time.perf_counter()
    results = solve_batch(providers, _batch_config(), certify=True,
                          shared_structure=True, warm_start_basis=warm_start_basis)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v - counts[k] for k, v in _graph_counts().items()}
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
        graphs=_graph_fields(counts), graph_evictions=counts["evictions"],
        **_step_cache_fields(), peak_device_MB=f"{peak / 1e6:.1f}", **_CARD,
    )
    return results


def _step_cache_fields(group=None):
    """The process-wide cache of steps (with ``group``, the cache of the
    steps sharded over that column group): its entries, the bytes it holds
    (pools, static buffers, tensors read in place), its largest graph pool
    and the batch widths of its entries."""
    from relp_tpu_torch.simplex import graphs

    cache = graphs.steps(group)
    entries = list(cache._entries.values())
    widths = sorted({entry.slots[0][1][0] for entry in entries})  # state's B
    return dict(step_cache_entries=len(entries),
                step_cache_MB=f"{cache.nbytes() / 1e6:.1f}",
                step_pool_max_MB=f"{max((e.pool_bytes for e in entries), default=0) / 1e6:.1f}",
                step_widths=",".join(map(str, widths)) or "none")


def phase_batch_memory(torch):
    """Device memory of solve_batch (no certification) on each cold family,
    with the one shared tableau that lower_batch hands out and with B
    stacked copies of it (the default layout, made here by a lower_batch
    that returns A.contiguous()), each with the steps replayed and with
    every step eager, each from an empty cache of steps and an emptied
    allocator cache: the same results, the peak allocated and reserved
    bytes, what stays allocated after the call, and the cache of steps
    (its bytes and its largest pool when the call's steps end, before a
    stacked tableau's steps are released)."""
    from relp_tpu_torch.parallel import batch_driver, solve_batch
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import FAMILIES, scenario_family

    kept, release = batch_driver.lower_batch, graphs.ChunkGraphs.release
    at_release = {}

    def with_copies(*args, **kwargs):
        problems, A, *rest = kept(*args, **kwargs)
        return (problems, A.contiguous(), *rest)

    def recording_release(cache, *tensors):
        at_release.update(_step_cache_fields())
        return release(cache, *tensors)

    for name, fam in FAMILIES.items():
        peaks, outcomes = {}, {}
        for run, lower, graphed in (("shared", kept, True), ("shared_eager", kept, False),
                                    ("copies", with_copies, True),
                                    ("copies_eager", with_copies, False)):
            providers = scenario_family(**fam)
            batch_driver.lower_batch = lower
            graphs.ChunkGraphs.release = recording_release
            steps = graphs.DEVICE_TYPES
            if not graphed:
                graphs.DEVICE_TYPES = ()
            graphs._STEPS = None
            at_release.clear()
            try:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                results = solve_batch(providers, _batch_config(), certify=False,
                                      shared_structure=True)
                torch.cuda.synchronize()
                peaks[run] = torch.cuda.max_memory_allocated()
                _line("batch/memory", family=name, run=run, scenarios=fam["count"],
                      peak_allocated_MB=f"{peaks[run] / 1e6:.1f}",
                      peak_reserved_MB=f"{torch.cuda.max_memory_reserved() / 1e6:.1f}",
                      kept_after_MB=f"{(torch.cuda.memory_allocated() - before) / 1e6:.1f}",
                      **{f"at_release_{k}": v for k, v in at_release.items()},
                      **{f"after_{k}": v for k, v in _step_cache_fields().items()
                         if k in ("step_cache_entries", "step_cache_MB")}, **_CARD)
                _check(lower is kept or not graphs.steps()._entries,
                       f"batch/memory {name}: the cache kept steps of a stacked tableau")
            finally:
                batch_driver.lower_batch = kept
                graphs.ChunkGraphs.release = release
                graphs.DEVICE_TYPES = steps
                graphs._STEPS = None
            outcomes[run] = [(r.status.value, tuple(r.basis), r.stats.iterations)
                             for r in results]
        _check(len({repr(o) for o in outcomes.values()}) == 1,
               f"{name}: one shared tableau, B copies and eager steps solve differently")
        M, N = _family_shapes()[name]
        _line(
            "batch/memory", family=name, scenarios=fam["count"],
            peak_shared_MB=f"{peaks['shared'] / 1e6:.1f}",
            peak_copies_MB=f"{peaks['copies'] / 1e6:.1f}",
            peak_shared_eager_MB=f"{peaks['shared_eager'] / 1e6:.1f}",
            peak_copies_eager_MB=f"{peaks['copies_eager'] / 1e6:.1f}",
            saved_MB=f"{(peaks['copies'] - peaks['shared']) / 1e6:.1f}",
            copies_of_the_tableau_MB=f"{(fam['count'] - 1) * M * N * 4 / 1e6:.1f}",
            same_results=True,
        )


@contextlib.contextmanager
def _counting_chunks(calls):
    """Count the device steps that solve_batch runs, graphed or eager, by
    the chunk runner each runs (a kernel-route ``_batch_step`` as
    megakernel_run_chunk, a torch-route one and the polish chunk as
    batched_run_chunk): through batch_driver.run_step, which every step
    goes through (a replayed graph calls no chunk runner)."""
    from relp_tpu_torch.parallel import batch_driver

    for n in ("batched_run_chunk", "batched_dual_run_chunk", "megakernel_run_chunk"):
        calls[n] = 0

    def wrapper(run_step):
        def run(body, state, inputs, **kwargs):
            if body is batch_driver._batch_step:
                name = "megakernel_run_chunk" if kwargs["mega"] else "batched_run_chunk"
            else:
                name = body.__name__
            calls[name] += 1
            return run_step(body, state, inputs, **kwargs)
        return run

    with _wrapped(batch_driver, "run_step", wrapper):
        yield


def phase_batch_warm(torch, np):
    """The warm family (the resident family's LP, +-40% wobbles) started
    from the optimum of its unperturbed base: every scenario needs dual
    pivots.  Its pinned digest (the JAX package's cold solve), no phase 1,
    the dual chunks and the phase-2 re-verification on the batched torch
    path, and no batched-pivot kernel launch.  The device solve's seconds
    beside those of the same call with every step eager, made just before
    and just after it."""
    from relp_tpu_torch.ops import batch_pivot
    from relp_tpu_torch.parallel import solve_batch
    from relp_tpu_torch.simplex import SolveStatus, graphs, solve_relaxation
    from relp_tpu_torch.testing import (
        WARM_FAMILY,
        WARM_FAMILY_OBJECTIVES_SHA256,
        scenario_base,
        scenario_family,
    )

    gf, counts = scenario_base(WARM_FAMILY["m"], WARM_FAMILY["n"], WARM_FAMILY["seed"])
    base = solve_relaxation(gf.derive_matrix_data(counts), _batch_config())
    _check(base.status is SolveStatus.FINITE_OPTIMUM, f"warm base {base.status}")

    def eager_call():  # every step eager, no certification
        kept = graphs.DEVICE_TYPES
        graphs.DEVICE_TYPES = ()
        try:
            return solve_batch(scenario_family(**WARM_FAMILY), _batch_config(),
                               certify=False, shared_structure=True,
                               warm_start_basis=base.basis)
        finally:
            graphs.DEVICE_TYPES = kept

    eager_first = eager_call()
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
    # The same call with every step eager (no certification) before and
    # after it, for the device solve's seconds (the first call of a
    # process at a shape also pays one-time work).
    eager = eager_call()
    for other in (eager_first, eager):
        _check([(r.basis, r.stats.iterations, r.stats.dual_iterations) for r in other]
               == [(r.basis, r.stats.iterations, r.stats.dual_iterations) for r in results],
               "batch/warm: the eager steps solve differently")
    _line(
        "batch/warm", lps_with_dual_pivots=with_dual,
        device_solve_s=f"{max(r.stats.wall_time_s for r in results):.3f}",
        eager_before_device_solve_s=f"{max(r.stats.wall_time_s for r in eager_first):.3f}",
        eager_device_solve_s=f"{max(r.stats.wall_time_s for r in eager):.3f}",
        eager_same_results=True,
        max_dual_pivots=max(r.stats.dual_iterations for r in in_batch),
        phase2_pivots=sum(r.stats.iterations - r.stats.dual_iterations
                          for r in in_batch),
        dual_chunks=calls["batched_dual_run_chunk"],
        phase2_torch_chunks=calls["batched_run_chunk"],
        megakernel_chunks=calls["megakernel_run_chunk"],
    )


def phase_batch_chunk(torch, np):
    """Marginal pivots/s of the whole batch from the phase-2 start: the
    kernel path, the batched torch path eager (plain) and the same chunk
    replayed from its CUDA graph (graph, as solve_batch runs it): the median
    of 8 interleaved (K - 10)-pivot differences, with a host read of the
    pivot count in the timed region.  K is at most 150 and below the fewest
    phase-2 pivots of any LP (found by one kernel chunk), so that every LP
    pivots throughout the window on every path and the torch paths run no
    masked no-op iterations."""
    from relp_tpu_torch.parallel.batch import batched_run_chunk, megakernel_run_chunk
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.simplex.kernels import PRICE_STEEPEST

    cfg = _batch_config()
    tol = dict(opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol, degen_tol=cfg.feas_tol)
    rates = {}
    paths = ("kernel", "plain", "graph")
    for name in ("resident", "blocked"):
        A, c2, cand, st = _family_phase2_start(torch, name)
        B = A.shape[0]
        start = int(st.iteration.sum())
        captured = graphs.ChunkGraphs()

        def run(path, chunk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if path == "kernel":
                out = megakernel_run_chunk(st, A, c2, cand, chunk=chunk, **tol)
            elif path == "plain":
                out = batched_run_chunk(st, A, A, c2, cand, pricing=PRICE_STEEPEST,
                                        chunk=chunk, **tol)
            else:
                out = captured.run(batched_run_chunk, st,
                                   dict(A_scan=A, A_full=A, c=c2, candidate_mask=cand),
                                   pricing=PRICE_STEEPEST, chunk=chunk, early_exit=False,
                                   **tol)
            pivots = int(out.iteration.sum())  # the host read, inside the timing
            return time.perf_counter() - t0, pivots - start

        probe = megakernel_run_chunk(st, A, c2, cand, chunk=150, **tol)
        fewest = int((probe.iteration - st.iteration).min())
        big = min(150, fewest - max(5, fewest // 10))
        _check(big >= 30, f"{name}: only {fewest} phase-2 pivots in the fewest LP")
        capture_s = graphs.CAPTURE_SECONDS
        for path in paths:  # warm up (and capture) outside the timed region
            run(path, 10)
            run(path, big)
        capture_s = graphs.CAPTURE_SECONDS - capture_s
        est = {path: [] for path in paths}
        counts = {}
        for rep in range(8):
            order = paths if rep % 2 == 0 else paths[::-1]
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
            graph_pivots_10_K=counts["graph"],
            all_active=all(c == (10 * B, big * B) for c in counts.values()),
            kernel_pivots_per_s=f"{med['kernel']:.0f}",
            plain_pivots_per_s=f"{med['plain']:.0f}",
            graph_pivots_per_s=f"{med['graph']:.0f}",
            kernel_q1_q3=quart["kernel"], plain_q1_q3=quart["plain"],
            graph_q1_q3=quart["graph"], graph_capture_s=f"{capture_s:.2f}", **_CARD,
        )
    return rates


# batch/graph's cases: (kind of testing.step_case, family, stop_at_zero).
_BATCH_GRAPH_CASES = (
    ("kernel", "resident", True), ("kernel", "resident", False),
    ("kernel", "blocked", True), ("kernel", "blocked", False),
    ("torch_float32", "resident", True), ("torch_float32", "resident", False),
    ("torch_float64", "resident", True), ("torch_float64", "resident", False),
    ("dual", "warm", None), ("polish", "resident", None),
)


def phase_batch_graph(torch, np):
    """solve_batch's device steps (testing.step_case at the families' full
    shapes, 150-pivot chunks), each from one state eagerly
    (batch_driver.run_step) and through a CUDA graph (the cache solve_batch
    uses is of the same class), then a second step from the first one's
    output both ways: the kernel route at both family shapes, the batched
    torch path in f32 and f64 (f32 scans) with and without the stop at zero,
    the warm family's dual chunk and the f64 polish chunk.  Whether the
    whole state and the report are bitwise equal, the batched-pivot
    launches of a replay against an eager step, the capture's seconds
    (warm-up included), a replay's ms and the eager step's ms.  A
    replay's launch count is graphs.py's bookkeeping (its capture's count,
    added at each replay); on the kernel route the batched-pivot kernels
    that one replay ran are also counted in a profiler trace of it
    (``traced_launches``), which must be the eager step's.  Returns
    ["kind@shape:fields"] for the cases that differ."""
    from relp_tpu_torch.parallel.batch_driver import _batch_step, run_step
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import FAMILIES, WARM_FAMILY, step_case

    families = dict(FAMILIES, warm=WARM_FAMILY)
    chunk = _batch_config().chunk_size
    differ = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def split(out):  # (state, report or None)
        return out if body is _batch_step else (out, None)

    def bits_differ(got, want):
        (g, g_rep), (w, w_rep) = split(got), split(want)
        fields = [f for f, x, y in zip(w._fields, g, w)
                  if not torch.equal(x.reshape(-1).view(torch.uint8),
                                     y.reshape(-1).view(torch.uint8))]
        if w_rep is not None and not torch.equal(g_rep.view(torch.uint8),
                                                 w_rep.view(torch.uint8)):
            fields.append("report")
        return fields

    for kind, family, stop in _BATCH_GRAPH_CASES:
        kw = {} if stop is None else dict(stop_at_zero=stop)
        body, state, inputs, static = step_case(kind, families[family], device="cuda",
                                                chunk=chunk, **kw)
        cache = graphs.ChunkGraphs()

        def graphed(st):
            return cache.run(body, st, inputs, early_exit=False, **static)

        def eager(st):
            return run_step(body, st, inputs, graphed=False, **static)

        before = _launch_counts()
        want, eager_ms = timed(lambda: eager(state))
        middle = _launch_counts()
        capture_s = graphs.CAPTURE_SECONDS
        first, _first_ms = timed(lambda: graphed(state))
        capture_s = graphs.CAPTURE_SECONDS - capture_s
        at_replay = _launch_counts()
        again, replay_ms = timed(lambda: graphed(state))
        after = _launch_counts()
        want2 = eager(split(want)[0])
        got2 = graphed(split(again)[0])
        torch.cuda.synchronize()
        fields = sorted(set(bits_differ(first, want) + bits_differ(again, want)
                            + bits_differ(got2, want2)))
        kernels = ("batched_pivot_chunk", "batched_pivot_chunk_blocked")
        eager_launches = [middle[k] - before[k] for k in kernels]
        replay_launches = [after[k] - at_replay[k] for k in kernels]
        if replay_launches != eager_launches:
            fields.append("launches")
        traced = "n/a"
        if kind == "kernel":
            traced = _kernel_events(torch, lambda: graphed(state), "batch_pivot_kernel")
            if traced != sum(eager_launches):
                fields.append("traced_launches")
        A = inputs.get("A", inputs.get("A_full"))
        shape = "x".join(map(str, A.shape))
        if fields:
            differ.append(f"{kind}@{shape}:{','.join(fields)}")
        pivots = int((split(want2)[0].iteration - state.iteration).sum())
        _line("batch/graph", kind=kind, family=family, shape=shape,
              dtype=str(A.dtype).replace("torch.", ""),
              scan_dtype=str(inputs["A_scan"].dtype).replace("torch.", ""),
              stop_at_zero=stop if stop is not None else "n/a", chunk=chunk,
              pivots_two_steps=pivots, bitwise_equal=not fields,
              differing_fields=",".join(fields) or "none",
              launches_eager="/".join(map(str, eager_launches)),
              launches_replay="/".join(map(str, replay_launches)),
              traced_launches=traced, capture_s=f"{capture_s:.3f}", replay_ms=f"{replay_ms:.3f}",
              eager_ms=f"{eager_ms:.3f}", **_CARD)
    return differ


def _kernel_events(torch, fn, name: str) -> int:
    """The device kernels whose name holds ``name`` in a profiler trace of
    ``fn`` (the raw Kineto events, as in _device_busy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and name in e.name())


def _launch_counts():
    """Every kernel's launch counter, by the name of its JSON entry."""
    from relp_tpu_torch.ops import batch_pivot, eta_ring, price_scan
    from relp_tpu_torch.tools import probe_dot_precision as probe

    return {
        "fused_price_scan": price_scan.LAUNCHES,
        **{f"fused_price_scan_{name}": n for name, n in price_scan.LAUNCHES_BY_DTYPE.items()},
        "batched_pivot_chunk": batch_pivot.LAUNCHES_RESIDENT,
        "batched_pivot_chunk_blocked": batch_pivot.LAUNCHES_BLOCKED,
        **{f"eta_{kind}": n for kind, n in eta_ring.LAUNCHES.items()},
        **{f"probe_dot_{kind}": probe.LAUNCHES[kind] for kind in probe.KINDS},
        # The captured chunks and steps: captures/replays/capture seconds,
        # and the entries the process-wide cache of steps evicted.
        "graphs": _graph_fields(_graph_counts()),
        "graph_evictions": _graph_counts()["evictions"],
    }


def _zero_launch_counts():
    from relp_tpu_torch.ops import batch_pivot, eta_ring, price_scan
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.tools import probe_dot_precision as probe

    price_scan.LAUNCHES = 0
    for name in price_scan.LAUNCHES_BY_DTYPE:
        price_scan.LAUNCHES_BY_DTYPE[name] = 0
    batch_pivot.LAUNCHES_RESIDENT = batch_pivot.LAUNCHES_BLOCKED = 0
    for kind in eta_ring.LAUNCHES:
        eta_ring.LAUNCHES[kind] = 0
    for kind in probe.KINDS:
        probe.LAUNCHES[kind] = 0
    graphs.CAPTURES = graphs.REPLAYS = graphs.EVICTIONS = 0
    graphs.CAPTURE_SECONDS = 0.0


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
    for mode in (["--mip"], ["--first-order"], ["--basis-inverse", "lu"],
                 ["--basis-inverse", "lu", "--pricing", "dantzig"]):
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


def _solves_digest(results) -> str:
    """sha256 of each result's status, basis, pivots and dual pivots."""
    return hashlib.sha256(repr([
        (r.status.value, tuple(r.basis or ()), r.stats.iterations,
         r.stats.dual_iterations) for r in results]).encode()).hexdigest()[:16]


@contextlib.contextmanager
def _counting_solves(tally):
    """Count the LP solves that branch & bound asks for through the module
    attributes its lazy imports read: the solve_batch calls, their LPs and
    single-LP fallbacks (``stats.batch_fallback``), the single-LP solves
    outside a batch, the certification time the returned results report
    (``stats.certify_time_s``) and the seconds inside those calls
    (``lp_s``); ``tally["waves"]`` lists each call in order as (LPs,
    ``_solves_digest`` of its results), ``tally["ends"]`` the clock at its
    end (``t0`` at the start).  ``tally["inside"]`` is the depth
    of solve_batch calls in progress."""
    from relp_tpu_torch.parallel import batch_driver
    from relp_tpu_torch.simplex import driver

    tally.update(batched_solves=0, batched_lps=0, fallbacks=0, single_solves=0,
                 certify_s=0.0, lp_s=0.0, inside=0, waves=[], ends=[],
                 t0=time.perf_counter())

    def batch(solve_batch):
        def run(providers, *args, **kwargs):
            tally["inside"] += 1
            t0 = time.perf_counter()
            try:
                results = solve_batch(providers, *args, **kwargs)
            finally:
                tally["inside"] -= 1
            tally["lp_s"] += time.perf_counter() - t0
            tally["batched_solves"] += 1
            tally["batched_lps"] += len(results)
            tally["fallbacks"] += sum(bool(r.stats.batch_fallback) for r in results)
            tally["certify_s"] += sum(r.stats.certify_time_s for r in results)
            tally["waves"].append((len(results), _solves_digest(results)))
            tally["ends"].append(time.perf_counter())
            return results
        return run

    def single(solve_relaxation):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            result = solve_relaxation(*args, **kwargs)
            if not tally["inside"]:  # a batch's fallbacks count with the batch
                tally["lp_s"] += time.perf_counter() - t0
                tally["single_solves"] += 1
                tally["certify_s"] += result.stats.certify_time_s
                tally["waves"].append((1, _solves_digest([result])))
                tally["ends"].append(time.perf_counter())
            return result
        return run

    with _wrapped(batch_driver, "solve_batch", batch), \
            _wrapped(driver, "solve_relaxation", single):
        yield


def _keeping_inputs(module, name, kept, when=lambda *args: True):
    """``_wrapped``: the inputs of the first call of ``module.name`` for
    which ``when(*args)`` holds are kept in ``kept[name]`` as (args, kwargs),
    contiguous tensors cloned, also inside named tuples (a state, a df
    pair), with one clone for what is one tensor (a captured chunk's key
    tells A_scan that is A_full apart); a tableau expanded over a batch is
    read-only and kept as it is."""
    import torch

    def wrapper(fn):
        def run(*args, **kwargs):
            if name not in kept and when(*args):
                clones = {}

                def keep(a):
                    if torch.is_tensor(a) and a.is_contiguous():
                        if id(a) not in clones:
                            clones[id(a)] = a.clone()
                        return clones[id(a)]
                    if isinstance(a, tuple) and hasattr(a, "_fields"):
                        return type(a)(*(keep(x) for x in a))
                    return a

                kept[name] = (tuple(keep(a) for a in args), dict(kwargs))
            return fn(*args, **kwargs)
        return run

    return _wrapped(module, name, wrapper)


@contextlib.contextmanager
def _keeping_kernel_inputs(kept, when):
    """The inputs of a batched-pivot kernel's launch in a real step of
    solve_batch, replayed or eager, kept in ``kept[name]`` as (args,
    kwargs) of the kernel's wrapper: the first kernel-route ``_batch_step``
    whose kernel is ``name`` (the tableau's shape decides) and for whose
    tableau ``when[name](A)`` holds.  A step launches its kernel first, on
    the step's own state and inputs, so they are the launch's; read at
    batch_driver.run_step, every step's call, not at the wrapper, which a
    graph calls only at its warm-up (a one-pivot chunk) and capture."""
    from relp_tpu_torch.parallel import batch_driver
    from relp_tpu_torch.parallel.batch import _megakernel_variant

    names = {"resident": "batched_pivot_chunk", "blocked": "batched_pivot_chunk_blocked"}

    def wrapper(run_step):
        def run(body, state, inputs, **kwargs):
            if body is batch_driver._batch_step and kwargs["mega"]:
                A = inputs["A"]
                name = names[_megakernel_variant(A.shape)]
                if name not in kept and when[name](A):
                    keep = lambda t: t.clone() if t.is_contiguous() else t  # noqa: E731
                    args = (A, inputs["c"], inputs["cand"], state.Binv, state.xB,
                            state.pi, state.basis, state.in_basis, state.gamma,
                            state.status, state.iteration, state.degen_count)
                    kept[name] = (tuple(keep(a) for a in args), {
                        k: kwargs[k] for k in ("chunk", "opt_tol", "pivot_tol",
                                               "degen_tol", "stop_at_zero")})
            return run_step(body, state, inputs, **kwargs)
        return run

    with _wrapped(batch_driver, "run_step", wrapper):
        yield


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

    if "result" not in _HIGHS:
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
    graph_counts = _graph_counts()
    t0 = time.perf_counter()
    with _counting_solves(tally):
        mip = solve_mip(mknap(**MKNAP), cfg, **limits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graph_counts = {k: v - graph_counts[k] for k, v in _graph_counts().items()}
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
        device_solve_s=f"{tally['lp_s'] - tally['certify_s']:.3f}",
        bnb_host_s=f"{wall - tally['lp_s']:.3f}",
        graphs=_graph_fields(graph_counts), graph_evictions=graph_counts["evictions"],
        **_step_cache_fields(), **{k: tally[k] for k in ("blocked_wave_after_nodes",) if k in tally},
    )
    return mip


# Node LPs that mip/real must solve inside the batch: 35 of 394 did on an
# H100 (383 nodes; PERF.md), the others fell back to the single-LP driver.
_MIN_IN_BATCH_F32 = 16

# mip/real's node limit: on an H100 the first 64-wide wave that launched the
# blocked kernel began after 255 solved nodes (PERF.md), and a wave takes
# nodes while nodes_solved + len(wave) < node_limit, so 255 + 64 is the
# least limit that still runs that wave whole.
_MIP_REAL_NODES = 319


def phase_mip_real(torch, np):
    """solve_mip in its default configuration (f32; Gomory and cover cuts,
    strong branching, the rounding dive) on the Chu-Beasley knapsack, 64
    nodes a wave, cut at _MIP_REAL_NODES nodes (_solve_mknap's checks).
    The node count, not the clock, ends it, so that every host reaches the
    first whole wave of node LPs too deep for the resident kernel (it runs
    the blocked one); 300 s only stop a runaway.  The
    inputs of the first launch of each batched-pivot kernel on a whole
    node wave (its cold batch) and of the first scan launch inside a batch
    (a node LP that
    fell back to the single-LP driver) are kept: returns the replay that
    holds each kernel against its plain version on them (the scan's also
    timed), to run once the path's launches are read."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.simplex import kernels

    tally, kept = {}, {}

    def wave(A, *_rest):  # a whole node wave (strong branching's are narrower)
        return A.shape[0] == 64

    def blocked_wave(A, *_rest):
        # Also the nodes solved before this wave: its node count at least
        # that plus 64 is the least node_limit that reaches it.
        if not wave(A):
            return False
        frame, outer = sys._getframe(), None
        while frame is not None:
            if frame.f_code.co_name == "solve_mip" and "wave" in frame.f_locals:
                outer = frame
            frame = frame.f_back
        if outer is not None:
            tally["blocked_wave_after_nodes"] = outer.f_locals["result"].nodes_solved
        return True

    with _keeping_kernel_inputs(kept, {"batched_pivot_chunk": wave,
                                       "batched_pivot_chunk_blocked": blocked_wave}), \
            _keeping_inputs(kernels, "fused_price_scan", kept,
                            when=lambda *_args: tally.get("inside", 0) > 0):
        _solve_mknap(torch, np, "mip/real", SolverConfig(), _MIN_IN_BATCH_F32,
                     tally, batch_width=64, node_limit=_MIP_REAL_NODES, time_limit_s=300)
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
    errors["fused_price_scan"], errors["fused_price_scan_times"] = _replay_scan(
        torch, "mip/kernel", args)
    _check(_launch_counts()["fused_price_scan"] > before,
           "mip/real replay: the scan kernel did not launch")
    return errors


def phase_mip_real64(torch, np, found):
    """The same knapsack to a proven optimum: solve_mip with --dtype float64
    and the CLI's default 16 nodes a wave (f64 node LPs pass the batch
    driver's residual gates, so the waves stay in the batch).  Besides
    _solve_mknap's checks: optimal and certified, the objective HiGHS's
    optimum, the best bound equal to it, nearly every node LP solved in the
    batch.  Its LP solves, call by call, are left in ``found["tally"]``
    for mip/real64/eager."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.simplex import SolveStatus

    from relp_tpu_torch.simplex import kernels

    tally, kept = {}, {}

    def first_of_each_dtype(scan):
        def run(*args):
            if str(args[1].dtype) not in kept:
                kept[str(args[1].dtype)] = tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args)
            return scan(*args)
        return run

    with _wrapped(kernels, "fused_price_scan", first_of_each_dtype):
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
    _check(kept, "mip/real64 never called the scan")
    found["tally"] = tally

    def replays():  # the first scan of each dtype (f32 node LPs, f64 polish)
        out = [_replay_scan(torch, "mip64/kernel", args) for args in kept.values()]
        return max(err for err, _t in out), out[-1][1]

    return replays


# mip/real64/eager's node limit: about a fifth of mip/real64's search
# (1,969 nodes on an H100; PERF.md).
_MIP64_EAGER_NODES = 400


def phase_mip_real64_eager(torch, np, found):
    """mip/real64 again with every captured step and chunk eager
    (graphs.DEVICE_TYPES emptied), cut at _MIP64_EAGER_NODES nodes, with
    _solve_mknap's checks: its LP solves, call by call (solve_batch waves
    and single-LP solves), must be mip/real64's, each call's results by the
    digest of every LP's status, basis, pivots and dual pivots; one call
    may be a narrower wave than the graphed run's (the cut: a wave takes
    nodes while they stay under the limit), the strong branching after it
    is that of the same nodes.  The seconds of the same calls in the graphed
    run beside the eager ones."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.simplex import graphs

    graphed = found["tally"]
    kept = graphs.DEVICE_TYPES
    graphs.DEVICE_TYPES = ()
    tally = {}
    try:
        mip = _solve_mknap(torch, np, "mip/real64/eager", SolverConfig(dtype="float64"), 1,
                           tally, batch_width=16, node_limit=_MIP64_EAGER_NODES,
                           time_limit_s=300)
    finally:
        graphs.DEVICE_TYPES = kept
    eager, waves = tally["waves"], graphed["waves"]
    differ = [i for i, (e, g) in enumerate(zip(eager, waves)) if e != g]
    cut = [i for i in differ if eager[i][0] < waves[i][0]]
    _check(len(eager) <= len(waves) and differ == cut and len(cut) <= 1,
           f"mip/real64/eager: LP-solve calls {differ[:5]} of {len(eager)} differ from "
           f"mip/real64's ({[(eager[i], waves[i]) for i in differ[:2]]})")
    last = len(eager) - 1
    _line("mip/real64/eager", nodes_solved=mip.nodes_solved, calls=len(eager),
          graphed_calls=len(waves), lp_solves=sum(k for k, _d in eager),
          same_calls=len(eager) - len(cut),
          cut_wave=f"call {cut[0]}: {eager[cut[0]][0]} of {waves[cut[0]][0]} LPs"
          if cut else "none",
          eager_prefix_s=f"{tally['ends'][last] - tally['t0']:.3f}",
          graphed_prefix_s=f"{graphed['ends'][last] - graphed['t0']:.3f}",
          eager_lp_s=f"{tally['lp_s']:.3f}", **_CARD)


def _reconstructed_objective(gf, md, result):
    """The full-space exact objective of a reduced certified result."""
    reduced = md.reconstruct_solution(result.exact_bfs)
    return gf.compute_full_solution_with_reduced_solution(reduced).objective_value


# PDHG's iterations on first_order/real, cut from the default 100,000 to
# keep the whole script inside the 1,200 s that a run on the card is given
# (the kernels' build included).  PDHG stops unconverged either way, and
# the crossover refuses its point: the phase covers the cold finish.
_FIRST_ORDER_REAL_ITERS = 20_000


def phase_first_order_real(torch):
    """solve_first_order (PDHG + crossover) on main/real's LP after the same
    presolve and standardize as the CLI: certified, main/real's pinned
    digest; the PDHG statistics, the crossover's pivots, the wall split.
    PDHG stops unconverged, the crossover refuses its basis and the finish
    is a cold solve with a phase 1 (checked): this phase covers that route;
    mip/small's --first-order covers the warm finish."""
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
    result = solve_first_order(md, SolverConfig(), max_iters=_FIRST_ORDER_REAL_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(result.status is SolveStatus.FINITE_OPTIMUM and result.stats.certified,
           f"first_order/real: {result.status} certified={result.stats.certified}")
    digest = hashlib.sha256(
        str(_reconstructed_objective(gf, md, result)).encode()).hexdigest()
    _check(digest == REAL_SIZE_OBJECTIVE_SHA256, f"first_order/real digest {digest}")
    # A refused crossover basis leaves the finish a cold two-phase solve.
    cold = result.stats.phase1_iterations > 0 and not result.stats.dual_iterations
    _check(cold, "first_order/real: the crossover basis was taken (no cold finish)")
    fo = result.first_order_stats
    _line(
        "first_order/real", m=REAL_SIZE["m"], n=REAL_SIZE["n"], status=result.status.value,
        certified=True, digest_ok=True, finish="cold", pdhg_iterations=fo.iterations,
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
    its matrix larger than L2; tools.pdhg_check's call), its chunks replayed
    from a CUDA graph, then again eager: the same point bit for bit;
    iterations/s and ms an iteration of both, and the device time of one
    200-iteration chunk, replayed and eager, against its bound (A read
    twice per iteration at 3.35 TB/s); the KKT residuals of the returned
    point in f64 on the host against the port's f32 evaluation on the card,
    and its primal residual against the same call's in f64 on the CPU."""
    from relp_tpu_torch.firstorder import pdhg
    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.testing import PDHG_F64_CPU
    from relp_tpu_torch.tools import pdhg_check

    runs = {}
    for path in ("graph", "eager"):
        keep = graphs.DEVICE_TYPES
        if path == "eager":
            graphs.DEVICE_TYPES = ()
        replays = graphs.REPLAYS
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[path] = (*pdhg_check.run(device), time.perf_counter() - t0,
                          graphs.REPLAYS - replays)
        finally:
            graphs.DEVICE_TYPES = keep
    x, y, st, scaled, host, wall, replays = runs["graph"]
    xe, ye, ste, _scaled, _host, wall_eager, replays_eager = runs["eager"]
    _check(np.all(np.isfinite(x)) and np.all(np.isfinite(y)), "first_order/pdhg: non-finite")
    _check(replays == st.iterations // 200 and replays_eager == 0,
           f"first_order/pdhg: {replays} replays graphed, {replays_eager} eager")
    _check(np.array_equal(x, xe) and np.array_equal(y, ye)
           and (st.iterations, st.restarts) == (ste.iterations, ste.restarts),
           "first_order/pdhg: the graphed point differs from the eager one")
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
    # One chunk on the card between CUDA events, from the returned point:
    # replayed from its graph (the copies in and out included) and eager.
    A_d, b_d, c_d, u_d = on_card
    chunk = 200
    carry = pdhg.pdhg_carry(xs_d, ys_d, xs_d, ys_d, 0.0, 1e-3, 1e-3)
    inputs = dict(A=A_d, b=b_d, c=c_d, u=u_d)
    cache = graphs.ChunkGraphs()
    ms = _events_ms(torch, lambda: cache.run(pdhg._pdhg_chunk, carry, inputs, chunk=chunk))
    eager_ms = _events_ms(torch, lambda: pdhg._pdhg_chunk(carry, **inputs, chunk=chunk))
    bytes_per_iter = 2 * A_d.numel() * 4
    bound_ms, bound_by = _bound(bytes_per_iter, 4.0 * A_d.numel())
    _line(
        "first_order/pdhg", m=As.shape[0], n=As.shape[1], dtype="float32",
        iterations=st.iterations, restarts=st.restarts, converged=st.converged,
        wall_s=f"{wall:.3f}", iterations_per_s=f"{st.iterations / st.wall_time_s:.0f}",
        solve_ms_per_iteration=f"{st.wall_time_s / st.iterations * 1e3:.5f}",
        eager_wall_s=f"{wall_eager:.3f}",
        eager_solve_ms_per_iteration=f"{ste.wall_time_s / ste.iterations * 1e3:.5f}",
        graphed_point_bitwise_eager=True, replays=replays,
        chunk_ms_per_iteration=f"{ms / chunk:.5f}",
        eager_chunk_ms_per_iteration=f"{eager_ms / chunk:.5f}",
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


def phase_lu_real(torch, found):
    """main/real's LP through solve_general_form on the LU engine: certified,
    the pinned digest; pivots, refactorizations, ms per pivot, the solve's
    seconds split into chunk replays and chunk exits (lu/split); then one
    phase-2 chunk of that solve replayed under the profiler for launches
    and device-busy time per pivot.  Leaves the result and its ms per pivot
    in ``found`` for mesh/lu.  Returns lu/kernel (run once the path's
    launches are read): the eta-ring kernels against their plain versions
    on that chunk's inputs."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.simplex import SolveStatus, engine, solve_general_form
    from relp_tpu_torch.testing import (
        REAL_SIZE,
        REAL_SIZE_OBJECTIVE_SHA256,
        generated_lp,
    )

    from relp_tpu_torch.simplex import graphs
    from relp_tpu_torch.simplex import lu as lu_mod

    kept, calls, split = {}, [], {}
    # An empty process-wide cache of chunks, so that its LU entries are
    # this solve's captures (mip/small's LU solves came before).
    graphs._CHUNKS = None
    graphs0 = _graph_counts()
    with _splitting_solve(torch, engine.LUEngine, split), \
            _keeping_profiled_chunk(engine.LUEngine, kept, calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, solution = solve_general_form(generated_lp(**REAL_SIZE),
                                              SolverConfig(basis_inverse="lu"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graph_counts = {k: v - graphs0[k] for k, v in _graph_counts().items()}
    _check(result.status is SolveStatus.FINITE_OPTIMUM and result.stats.certified,
           f"lu/real: {result.status} certified={result.stats.certified}")
    digest = hashlib.sha256(str(solution.objective_value).encode()).hexdigest()
    _check(digest == REAL_SIZE_OBJECTIVE_SHA256, f"lu/real digest {digest}")
    _check(graph_counts["replays"] == result.stats.chunks,
           f"lu/real: {graph_counts['replays']} replays for {result.stats.chunks} chunks")
    pivots = result.stats.iterations  # both phases' pivots
    solve_s = result.stats.wall_time_s - result.stats.certify_time_s
    by_eta0 = graphs.chunks().captured(lu_mod.lu_run_chunk, "eta0")
    replay = _Replay(torch, "lu/real", kept, calls)
    _line(
        "lu/real", m=REAL_SIZE["m"], n=REAL_SIZE["n"], status=result.status.value,
        certified=True, digest_ok=True, pivots=result.stats.iterations,
        phase1_pivots=result.stats.phase1_iterations,
        refactorizations=result.stats.refactorizations, chunks=result.stats.chunks,
        escalations=",".join(result.stats.escalations) or "none",
        wall_s=f"{wall:.3f}", solve_s=f"{solve_s:.3f}",
        certify_s=f"{result.stats.certify_time_s:.3f}",
        solve_ms_per_pivot=f"{solve_s / pivots * 1e3:.4f}",
        graphs=_graph_fields(graph_counts),
        captures_by_eta0=";".join(f"{k}:{n}" for k, n in by_eta0.items()),
        lu_solve_backend=str(torch.backends.cuda.preferred_linalg_library()),
    )
    _split_line("lu/split", split, solve_s, pivots)
    state = kept["run_chunk"][0][1]
    found.update(result=result, solve_ms_per_pivot=solve_s / pivots * 1e3, replay=replay,
                 state=state, prefix_s=calls[_PROFILED_CHUNK - 1] - t0)
    _line("lu/profile", chunk=_PROFILED_CHUNK, path="graph", **replay.fields())
    _name_strided_op(torch, state)
    return lambda: phase_lu_kernel(torch, kept["run_chunk"])


@contextlib.contextmanager
def _splitting_solve(torch, engine_cls, split):
    """``engine_cls``'s run_chunk (a replay, on a graphed engine),
    refactor and recompute_gamma each timed by two CUDA events recorded on
    the current stream around the call, with no synchronisation added: a
    call's span runs from the stream's reaching the first event (the call's
    start, or the end of work queued before it) to its reaching the second
    (the end of the call's device work, or of its host work where the
    stream is idle by then).  Their seconds and calls go into ``split``
    (chunk_s, chunks, refactor_s, refactors, gamma_s, gammas) when the
    block ends."""
    spans = []

    def timing(key, count):
        def wrapper(fn):
            def run(*args, **kwargs):
                first = torch.cuda.Event(enable_timing=True)
                second = torch.cuda.Event(enable_timing=True)
                first.record()
                try:
                    return fn(*args, **kwargs)
                finally:
                    second.record()
                    spans.append((key, count, first, second))
            return run
        return wrapper

    try:
        with _wrapped(engine_cls, "run_chunk", timing("chunk_s", "chunks")), \
                _wrapped(engine_cls, "refactor", timing("refactor_s", "refactors")), \
                _wrapped(engine_cls, "recompute_gamma", timing("gamma_s", "gammas")):
            yield
    finally:
        torch.cuda.synchronize()
        split.update(chunk_s=0.0, chunks=0, refactor_s=0.0, refactors=0, gamma_s=0.0,
                     gammas=0)
        for key, count, first, second in spans:
            split[key] += first.elapsed_time(second) / 1e3
            split[count] += 1


def _split_line(label, split, solve_s, pivots):
    """A solve's seconds (``solve_s``, ``pivots`` pivots) split into chunk
    replays and chunk exits: the refactorizations, the gamma refreshes and
    the rest (status and health reads, the drive-out of artificials, host
    bookkeeping, the host pipeline before the first chunk)."""
    exits = solve_s - split["chunk_s"]
    rest = exits - split["refactor_s"] - split["gamma_s"]
    _line(label, solve_s=f"{solve_s:.3f}", pivots=pivots, chunks=split["chunks"],
          chunk_s=f"{split['chunk_s']:.3f}",
          chunk_ms_per_pivot=f"{split['chunk_s'] / pivots * 1e3:.4f}",
          exits_s=f"{exits:.3f}", exits_ms_per_pivot=f"{exits / pivots * 1e3:.4f}",
          refactor_s=f"{split['refactor_s']:.3f}", refactors=split["refactors"],
          gamma_s=f"{split['gamma_s']:.3f}", gammas=split["gammas"],
          rest_s=f"{rest:.3f}", **_CARD)


# The one-block design that the eta-ring kernels replaced (one block
# walking the live slots, the whole vector waiting on each): its times on
# lu/real's last call of each pass (K = 60, M = 1920, f32, 59 live slots),
# us warm / L2-cold, as PERF.md section 6 records them (NVIDIA H100 80GB
# HBM3, 700.00 W).  Not measured here: printed beside this run's times on
# the text line only.  An LU pivot ran two of its BTRANs where the pair
# runs.
_ONE_BLOCK_RECORDED_US = {"eta_ftran": (39.46, 72.22), "eta_btran": (48.88, 80.55),
                          "eta_btran_pair": (97.76, 161.10)}


def _eta_bound(kind, n, M, itemsize, n_b=0):
    """(bound_ms, bound_by) of an eta-ring pass over ``n`` live slots (the
    pair: ``n`` and ``n_b``, through one read of the ring): the live ring
    and its rows read once, each vector read and written, the counts read;
    2M + 1 (FTRAN) or 2M + 3 (BTRAN) operations a slot and vector."""
    vectors = 2 if kind == "pair" else 1
    slots = max(n, n_b)
    bytes_moved = slots * (M * itemsize + 4) + vectors * (2 * M * itemsize + 4)
    ops = (n + n_b) * (2 * M + (1 if kind == "ftran" else 3))
    return _bound(bytes_moved, ops, F64_FLOPS if itemsize == 8 else F32_FLOPS)


def _eta_entries(kind, inputs):
    """{name: (launch, plain version, inputs)} of one kept eta-ring call
    (the pair's launch and plain version return two vectors): FTRAN
    against the plain loop; the pair, and eta_btran on its first vector,
    against the ordered twin."""
    from relp_tpu_torch.ops import eta_ring

    if kind == "ftran":
        return {"eta_ftran": (lambda: eta_ring.eta_ftran(*inputs),
                              lambda: eta_ring.eta_ftran_plain(*inputs), inputs)}
    single = inputs[:4]
    return {
        "eta_btran_pair": (lambda: eta_ring.eta_btran_pair(*inputs),
                           lambda: eta_ring.eta_btran_pair_plain(*inputs, order="kernel"),
                           inputs),
        "eta_btran": (lambda: eta_ring.eta_btran(*single),
                      lambda: eta_ring.eta_btran_plain(*single, order="kernel"), single),
    }


def _flat(torch, out):
    """One tensor of an entry's output (the pair's two vectors joined)."""
    return torch.cat(out) if isinstance(out, tuple) else out


def phase_lu_kernel(torch, chunk_args):
    """lu/kernel: lu/real's 20th chunk run once more, eagerly, from its kept
    entry state (``chunk_args``: the engine's run_chunk call), keeping the
    inputs of every call of eta_ftran and of eta_btran_pair (the ring's fill
    from its entry to its largest).  On every call each entry against its
    plain version bit for bit, twice (FTRAN: the plain loop; the pair, and
    eta_btran on its first vector: the ordered twin); on the first and the
    last call the times (``_time_eta``).  Returns {kernel: the last call's
    fields} for the kernels line."""
    from relp_tpu_torch.ops import eta_ring
    from relp_tpu_torch.simplex import graphs

    (engine, state, *args), kwargs = chunk_args
    calls = {"ftran": [], "pair": []}

    def keeping(kind):
        def wrapper(fn):
            def run(*inputs):
                calls[kind].append(tuple(t.clone() for t in inputs
                                         if isinstance(t, torch.Tensor)))
                return fn(*inputs)
            return run
        return wrapper

    keep = graphs.DEVICE_TYPES
    graphs.DEVICE_TYPES = ()  # the chunk eager: the wrappers run every call
    try:
        with _wrapped(eta_ring, "eta_ftran", keeping("ftran")), \
                _wrapped(eta_ring, "eta_btran_pair", keeping("pair")):
            out = type(engine).run_chunk(engine, state, *args, **kwargs)
    finally:
        graphs.DEVICE_TYPES = keep
    torch.cuda.synchronize()
    _check(int(out.iteration) > int(state.iteration), "lu/kernel: the chunk took no pivot")
    found = {}
    for kind, kept in calls.items():
        _check(bool(kept), f"lu/kernel: the chunk never called the {kind} entry")
        fills = []
        for inputs in kept:
            fills.append(int(inputs[2]))
            for name, (launch, plain, _inputs) in _eta_entries(kind, inputs).items():
                got, again, want = (_flat(torch, f()) for f in (launch, launch, plain))
                torch.cuda.synchronize()
                _check(torch.equal(got.view(torch.uint8), want.view(torch.uint8))
                       and torch.equal(got.view(torch.uint8), again.view(torch.uint8)),
                       f"lu/kernel: {name} differs from its plain version at fill "
                       f"{fills[-1]}")
        _line("lu/kernel", entry=kind, calls_checked=len(kept), bitwise_plain=True,
              repeat_bitwise=True, fills=f"{min(fills)}..{max(fills)}")
        for at, inputs in (("entry", kept[0]), ("last", kept[-1])):
            found.update(_time_eta(torch, kind, at, inputs))
    return found


def _time_eta(torch, kind, at, inputs):
    """One kept call's times and their lines, for each entry of the call
    (FTRAN; or the pair, and eta_btran on its first vector): the kernel
    warm, L2-cold and with no live slot; the slot-chain probe on the same
    ring (the floor of a pass that makes the whole vector wait on each
    slot; the pair's is two BTRAN chains, as that design ran two launches);
    the torch route's loops over the live slots and, for BTRAN, the
    ordered twin, replayed from a graph; the bound.  Returns {kernel:
    fields} for the kernels line."""
    from relp_tpu_torch.ops import eta_ring
    from relp_tpu_torch.tools.eta_ring_timing import slot_chain

    K, M = inputs[0].shape
    flush = _flush(torch)
    found = {}
    for name, (launch, ordered, args) in _eta_entries(kind, inputs).items():
        vals, rows = args[:2]
        counts = args[2::2]
        live = [min(max(int(c), 0), K) for c in counts]
        got = _flat(torch, launch())
        err = float((got.double() - _flat(torch, ordered()).double()).abs().max())
        empty = tuple(torch.zeros_like(t) if t.dim() == 0 else t for t in args)
        chain_kind = "ftran" if kind == "ftran" else "btran"

        def chain(counts=counts, chain_kind=chain_kind, vals=vals):
            for c in counts:
                slot_chain(chain_kind, vals, c)

        if kind == "ftran":
            loop = lambda: eta_ring.eta_ftran_plain(*args, steps=live[0])  # noqa: E731
        elif len(counts) == 1:
            loop = lambda: eta_ring.eta_btran_plain(*args, live[0])  # noqa: E731
        else:
            loop = lambda: eta_ring.eta_btran_pair_plain(*args, *live)  # noqa: E731
        times = {
            "ms": _graph_ms(torch, launch),
            "cold_ms": _graph_ms(torch, launch, flush=flush),
            "empty_ms": _graph_ms(torch, _eta_entries(kind, empty)[name][0]),
            "chain_ms": _graph_ms(torch, chain),
            "chain_cold_ms": _graph_ms(torch, chain, flush=flush),
            "plain_ms": _graph_ms(torch, loop),
        }
        extra = {}
        if kind != "ftran":
            times["ordered_plain_ms"] = _graph_ms(torch, ordered)
            loop_out = _flat(torch, loop())
            scale = float(loop_out.double().abs().max())
            extra["rel_err_vs_matmul_loop"] = (
                float((got.double() - loop_out.double()).abs().max()) / max(scale, 1e-300))
        bound_kind = "pair" if len(counts) == 2 else chain_kind
        bound_ms, bound_by = _eta_bound(bound_kind, live[0], M, vals.element_size(),
                                        live[1] if len(counts) == 2 else 0)
        fields = dict(max_abs_err=err, live_slots=live, shape=[K, M], bound_ms=bound_ms,
                      bound_by=bound_by, **extra, **times)
        recorded = _ONE_BLOCK_RECORDED_US[name]
        _line("lu/kernel", kernel=name, at=at, K=K, M=M,
              dtype=str(vals.dtype).replace("torch.", ""),
              live_slots="/".join(map(str, live)), bitwise_plain=True,
              max_abs_err=f"{err:.3e}", **{k: f"{v:.3e}" for k, v in extra.items()},
              **{k: f"{v:.5f}" for k, v in times.items()},
              below_chain=times["ms"] < times["chain_ms"],
              bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
              bound_share=f"{bound_ms / times['ms']:.4f}",
              one_block_design_recorded_warm_cold_us="/".join(f"{t:.2f}" for t in recorded),
              recorded_in="PERF.md section 6 (not this run)", **_CARD)
        found[name] = fields
    return found


def _name_strided_op(torch, state):
    """lu/solve: ``_profile_lu_solve`` on ``state``'s factors (saved to a
    temporary file) in a fresh process: in this one, which has profiled
    and captured graphs before, the trace of the solve held no kernel on
    the card."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "factors.pt")
        torch.save({"lu": state.lu.cpu(), "piv": state.piv.cpu(), "B0": state.B0.cpu()}, path)
        code = (f"import json, sys, torch; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                f"chip_smoke._CARD.update(json.loads({json.dumps(json.dumps(_CARD))})); "
                f"chip_smoke._profile_lu_solve(torch, {path!r})")
        done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=600)
    print(done.stdout, end="", flush=True)
    _check(done.returncode == 0, f"lu/solve: the profiling process failed: {done.stderr[-2000:]}")


def _profile_lu_solve(torch, path):
    """One ``_lu_solve`` (the f32 factors' solve and its refinement step)
    on the factors saved at ``path`` (lu, piv, B0), under the profiler with
    shapes and stacks, with adjoint False (FTRAN's) and True (the BTRANs'):
    each op that launches torch's ``_elementwise_kernel<128, 8, ...>`` (the
    trace links a kernel to its op by the op's external id), the ops around
    it, its operands' shapes and strides, the caller in the port, its
    launches and device us a solve; then its launches and us a
    steepest-edge pivot (one solve with adjoint False, two with True)."""
    import tempfile
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from relp_tpu_torch.simplex import lu as lu_mod

    state = SimpleNamespace(**{k: v.cuda() for k, v in torch.load(path).items()})

    def squeeze(value):
        return str(value).replace(" ", "")

    def around(event, pool):
        """The events of ``pool`` on ``event``'s thread that enclose it,
        innermost first."""
        t0, t1 = event["ts"], event["ts"] + event.get("dur", 0)
        outer = [e for e in pool if e is not event and e.get("tid") == event.get("tid")
                 and e["ts"] <= t0 and e["ts"] + e.get("dur", 0) >= t1]
        return sorted(outer, key=lambda e: e.get("dur", 0))

    M = state.B0.shape[0]
    rhs = torch.linspace(-1.0, 1.0, M, dtype=state.B0.dtype, device=state.B0.device)
    per_solve = {}
    for trans in (0, 1):
        lu_mod._lu_solve(state.lu, state.piv, state.B0, rhs, trans)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True, with_stack=True) as prof:
            lu_mod._lu_solve(state.lu, state.piv, state.B0, rhs, trans)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        ops = [e for e in events if e.get("cat") == "cpu_op"]
        frames = [e for e in events if e.get("cat") == "python_function"]
        by_id = {e.get("args", {}).get("External id"): e for e in ops}
        kernels = [e for e in events if e.get("cat") == "kernel"]
        hits = {}
        for k in kernels:
            if "_elementwise_kernel<128, 8" in k["name"] and "scatter_gather" not in k["name"]:
                hits.setdefault(k.get("args", {}).get("External id"), []).append(k)
        launches, us = 0, 0.0
        for ext, ks in hits.items():
            op = by_id.get(ext)
            args = op.get("args", {}) if op else {}
            caller = [e["name"] for e in around(op, frames) if "relp_tpu_torch" in e["name"]][:1] \
                if op else []
            launches += len(ks)
            us += sum(k.get("dur", 0.0) for k in ks)
            _line("lu/solve", adjoint=bool(trans), M=M, op=op["name"] if op else "not linked",
                  parents=">".join(e["name"] for e in around(op, ops)[:4]) if op else "none",
                  input_dims=squeeze(args.get("Input Dims", "not recorded")),
                  input_strides=squeeze(args.get("Input Strides", "not recorded")),
                  input_types=squeeze(args.get("Input type", "not recorded")),
                  caller=squeeze(caller[0]) if caller else "not recorded",
                  launches=len(ks), device_us=f"{sum(k.get('dur', 0.0) for k in ks):.2f}",
                  functor=squeeze(ks[0]["name"].split("_elementwise_kernel<128, 8,")[-1][:90]))
        if not launches:  # name what the solve did launch instead
            named = {}
            for k in kernels:
                op = by_id.get(k.get("args", {}).get("External id"))
                key = (op["name"] if op else "not linked", squeeze(k["name"][:60]))
                named[key] = named.get(key, 0) + 1
            _line("lu/solve", adjoint=bool(trans), M=M, found="none", kernels_by_op=";".join(
                f"{op}:{kernel}x{n}" for (op, kernel), n in named.items()) or "none")
        per_solve[trans] = (launches, us)
    launches = per_solve[0][0] + 2 * per_solve[1][0]
    us = per_solve[0][1] + 2 * per_solve[1][1]
    _line("lu/solve", summary=True, M=M, lu_strides=squeeze(tuple(state.lu.stride())),
          launches_per_solve=f"{per_solve[0][0]}/{per_solve[1][0]}",
          launches_per_pivot=launches, device_ms_per_pivot=f"{us / 1e3:.4f}", **_CARD)


# The chunk of lu/real, df32/real and mesh/lu replayed under the profiler.
_PROFILED_CHUNK = 20


def _keeping_profiled_chunk(engine_cls, kept, calls):
    """``_keeping_inputs`` of ``engine_cls.run_chunk``'s _PROFILED_CHUNK-th
    call, the time of each call appended to ``calls``."""

    def profiled(*_args):
        calls.append(time.perf_counter())
        return len(calls) == _PROFILED_CHUNK

    return _keeping_inputs(engine_cls, "run_chunk", kept, when=profiled)


class _PrefixDone(BaseException):
    """Ends a solve at its profiled chunk (not an Exception: nothing on the
    way catches it)."""


@contextlib.contextmanager
def _stopping_at_profiled_chunk(engine_cls, kept, calls):
    """``_keeping_profiled_chunk``, the solve then ended by _PrefixDone
    before that chunk runs."""

    def stop(fn):
        def run(*args, **kwargs):
            if "run_chunk" in kept:
                raise _PrefixDone
            return fn(*args, **kwargs)
        return run

    with _wrapped(engine_cls, "run_chunk", stop), \
            _keeping_profiled_chunk(engine_cls, kept, calls):
        try:
            yield
        except _PrefixDone:
            pass


class _Replay:
    """A kept chunk run again (its solve has just warmed the allocator and,
    for a graphed engine, captured its graph): its pivots, collectives and
    host ms per pivot in a first run; device-busy ms, device kernels, host
    launches and the costliest kernels per pivot in a second under the
    profiler."""

    def __init__(self, torch, label, kept, calls):
        from relp_tpu_torch.parallel import sharded
        from relp_tpu_torch.simplex import graphs

        _check("run_chunk" in kept,
               f"{label}: {len(calls)} chunks, fewer than {_PROFILED_CHUNK}")
        (engine, state, *args), kwargs = kept["run_chunk"]

        def run():
            # The class's own run_chunk: the keeping wrapper is gone by now.
            return int(type(engine).run_chunk(engine, state, *args, **kwargs).iteration)

        before, captures = sharded.COLLECTIVES, graphs.CAPTURES
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.pivots = run() - int(state.iteration)  # the host read ends the timing
        elapsed = time.perf_counter() - t
        self.collectives = sharded.COLLECTIVES - before
        _check(self.pivots > 0, f"{label}: the replayed chunk took no pivot")
        self.ms_per_pivot = elapsed * 1e3 / self.pivots
        self.busy_ms, launches, self.top, host = _device_busy(torch, run, self.pivots)
        self.launches_per_pivot = launches / self.pivots
        self.host_launches_per_pivot = sum(host.values()) / self.pivots
        # A graphed engine replays the graph its solve captured for this chunk.
        _check(graphs.CAPTURES == captures, f"{label}: the replayed chunk was captured again")

    def fields(self):
        idle = 1.0 - self.busy_ms / self.ms_per_pivot if self.busy_ms else None
        return dict(
            chunk_pivots=self.pivots,
            chunk_ms_per_pivot=f"{self.ms_per_pivot:.4f}",
            device_busy_ms_per_pivot=(f"{self.busy_ms:.4f}" if self.busy_ms
                                      else "not measured"),
            device_idle_share=f"{idle:.3f}" if idle is not None else "not measured",
            kernel_launches_per_pivot=f"{self.launches_per_pivot:.1f}",
            host_launches_per_pivot=f"{self.host_launches_per_pivot:.3f}",
            top_kernels=";".join(f"{name}:{ms:.4f}ms" for name, ms in self.top),
        )



def phase_eager_prefix(torch, label, engine_cls, config, graphed):
    """``label`` (lu/real or df32/real) again with every chunk eager
    (graphs.DEVICE_TYPES emptied for the phase), cut at the entry of its
    _PROFILED_CHUNK-th chunk: its state there must be the graphed run's,
    bit for bit (``graphed``: what the graphed phase left); its ms a pivot
    to there beside the graphed run's (both from the call, preparation
    included); then that chunk run eagerly under the profiler, as the
    graphed phase's profile line runs its replay."""
    from relp_tpu_torch.simplex import graphs, solve_general_form
    from relp_tpu_torch.testing import REAL_SIZE, generated_lp

    kept, calls = {}, []
    keep = graphs.DEVICE_TYPES
    graphs.DEVICE_TYPES = ()
    try:
        with _stopping_at_profiled_chunk(engine_cls, kept, calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve_general_form(generated_lp(**REAL_SIZE), config)
        replay = _Replay(torch, f"{label}/eager", kept, calls)
    finally:
        graphs.DEVICE_TYPES = keep
    state, want = kept["run_chunk"][0][1], graphed["state"]
    differ = [name for name, a, b in zip(want._fields, state, want)
              if not (a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                         b.reshape(-1).view(torch.uint8)))]
    _check(not differ, f"{label}/eager: the state entering chunk {_PROFILED_CHUNK} "
                       f"differs from the graphed run's in {differ}")
    pivots = int(state.iteration)
    prefix_s = calls[_PROFILED_CHUNK - 1] - t0
    _line(f"{label}/eager", prefix_chunks=_PROFILED_CHUNK - 1, pivots=pivots,
          bitwise_equal=True, differing_fields="none",
          eager_prefix_ms_per_pivot=f"{prefix_s / pivots * 1e3:.4f}",
          graphed_prefix_ms_per_pivot=f"{graphed['prefix_s'] / pivots * 1e3:.4f}",
          eager_prefix_s=f"{prefix_s:.3f}", graphed_prefix_s=f"{graphed['prefix_s']:.3f}",
          **_CARD)
    _line(f"{label.split('/')[0]}/profile", chunk=_PROFILED_CHUNK, path="eager",
          **replay.fields())


def _hold_df_bitwise(torch, np, label, state, A):
    """df_matvec (FTRAN: the df inverse times a df column of A) and
    df_vecmat (pi times the df inverse) on the card against the same calls
    on the CPU on the same f32 inputs: bitwise equal, hi and lo."""
    from relp_tpu_torch.ops import df32

    M = state.Binv.shape[0]
    j = int((A.hi != 0).sum(dim=0).argmax())  # the densest column
    calls = {
        "df_matvec": lambda t: df32.df_matvec(t["Bh"], t["Bl"], t["ah"], t["al"]),
        "df_vecmat": lambda t: df32.df_vecmat(t["ph"], t["pl"], t["Bh"], t["Bl"]),
    }
    card = dict(Bh=state.Binv, Bl=state.Binv_lo, ah=A.hi[:, j].contiguous(),
                al=A.lo[:, j].contiguous(), ph=state.pi, pl=state.pi_lo)
    host = {k: v.cpu() for k, v in card.items()}
    for name, call in calls.items():
        on_card, on_host = call(card), call(host)
        torch.cuda.synchronize()
        for part, c, h in zip(("hi", "lo"), on_card, on_host):
            c, h = c.cpu().numpy(), h.numpy()
            _check(np.array_equal(c.view(np.uint32), h.view(np.uint32)),
                   f"{label}: {name} {part} differs from the CPU's at M={M}")
        _line(label, call=name, M=M, column=j, card_vs_cpu="bitwise",
              max_abs=f"{float(np.abs(on_host[0].numpy()).max()):.3e}")


def phase_df32_real(torch, np, found):
    """main/real's LP through solve_general_form with the double-float
    carry (carry="df32"): certified by that rung (no escalation), main/
    real's pinned digest; pivots, chunk exits, scan launches, ms per pivot
    of the solve, the certification share, the captured chunks'
    captures/replays/seconds; one chunk of it replayed under the profiler
    for launches and device-busy time per pivot.  Leaves its state at the
    entry of its _PROFILED_CHUNK-th chunk and the seconds to it in
    ``found`` for df32/real/eager.  Returns the
    checks that launch kernels (run once the path's launches are read):
    the scan kernel against its plain version on the inputs this path gave
    it, and df_matvec/df_vecmat on the card against the CPU, bitwise, at
    the path's M."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.ops import price_scan
    from relp_tpu_torch.simplex import SolveStatus, df_kernels, engine, solve_general_form
    from relp_tpu_torch.testing import (
        REAL_SIZE,
        REAL_SIZE_OBJECTIVE_SHA256,
        generated_lp,
    )

    kept, calls = {}, []
    graphs0 = _graph_counts()
    with _keeping_profiled_chunk(engine.DoubleFloatEngine, kept, calls), \
            _keeping_inputs(df_kernels, "fused_price_scan", kept):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, solution = solve_general_form(generated_lp(**REAL_SIZE),
                                              SolverConfig(carry="df32"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graph_counts = {k: v - graphs0[k] for k, v in _graph_counts().items()}
    scan_launches = price_scan.LAUNCHES
    _check(graph_counts["replays"] == result.stats.chunks,
           f"df32/real: {graph_counts['replays']} replays for {result.stats.chunks} chunks")
    _check(result.status is SolveStatus.FINITE_OPTIMUM and result.stats.certified,
           f"df32/real: {result.status} certified={result.stats.certified}")
    _check(not result.stats.escalations,
           f"df32/real escalated to {result.stats.escalations}")
    digest = hashlib.sha256(str(solution.objective_value).encode()).hexdigest()
    _check(digest == REAL_SIZE_OBJECTIVE_SHA256, f"df32/real digest {digest}")
    _check(scan_launches > 0, "df32/real never launched the scan kernel")
    pivots = result.stats.iterations
    solve_s = result.stats.wall_time_s - result.stats.certify_time_s
    replay = _Replay(torch, "df32/real", kept, calls)
    _line(
        "df32/real", m=REAL_SIZE["m"], n=REAL_SIZE["n"], carry="df32",
        status=result.status.value, certified=True, digest_ok=True,
        escalations="none", pivots=pivots,
        phase1_pivots=result.stats.phase1_iterations,
        refactorizations=result.stats.refactorizations, chunks=result.stats.chunks,
        scan_launches=scan_launches, wall_s=f"{wall:.3f}", solve_s=f"{solve_s:.3f}",
        certify_s=f"{result.stats.certify_time_s:.3f}",
        certify_share=f"{result.stats.certify_time_s / wall:.3f}",
        solve_ms_per_pivot=f"{solve_s / pivots * 1e3:.4f}",
        graphs=_graph_fields(graph_counts),
    )
    _line("df32/profile", chunk=_PROFILED_CHUNK, path="graph", **replay.fields())
    (_engine, state, _A_scan, A_full, *_rest), _kw = kept["run_chunk"]
    found.update(state=state, prefix_s=calls[_PROFILED_CHUNK - 1] - t0)

    def holds():
        out = _replay_scan(torch, "df32/kernel", kept["fused_price_scan"][0])
        _hold_df_bitwise(torch, np, "df32/kernel", state, A_full)
        return out

    return holds


# PDHG iterations of mesh/world1's sharded and unsharded runs.
_MESH_PDHG_ITERS = 4_000


# mesh/world1's PDHG against the same call unsharded: in a world of one the
# two differ only in how the norms are summed (a sum of squares reduced over
# the group against torch.linalg.vector_norm), so the step sizes differ in
# the last f32 bits.  Each limit is about ten times what an H100 measured
# (PERF.md): the objective's relative difference 1.6e-6 and 7.4e-7, x's
# largest difference relative to its largest entry 1.7e-4, y's 9.3e-8.
_MESH_PDHG_OBJECTIVE_REL = 1e-5
_MESH_PDHG_X_REL = 1e-3
_MESH_PDHG_Y_REL = 1e-6


def phase_mesh_lu(torch, mesh, lu, window):
    """main/real's LP on the LU engine column-sharded over mesh/world1's
    (1, 1) mesh (solve_relaxation(mesh=..., basis_inverse="lu")), while its
    NCCL world of one is up, cut to a prefix: the solve runs until its
    _PROFILED_CHUNK-th chunk is called and stops there.  It must enter that
    chunk with lu/real's pivots, basis and status exactly (``lu``: what
    lu/real found at its own); collectives and ms per pivot of the prefix
    beside lu/real's; then that chunk replayed under the profiler for
    launches and device-busy time per pivot, as lu/profile does.  The path's
    launch counts (``window["mesh/lu"]``) cover the prefix only."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.parallel import sharded
    from relp_tpu_torch.simplex import engine, solve_relaxation
    from relp_tpu_torch.testing import REAL_SIZE, generated_lp

    ref = lu["state"]
    gf = generated_lp(**REAL_SIZE)
    gf.presolve()
    md = gf.derive_matrix_data(gf.standardize())
    kept, calls, split = {}, [], {}
    _zero_launch_counts()
    sharded.COLLECTIVES = 0
    with _splitting_solve(torch, engine.LUEngine, split), \
            _stopping_at_profiled_chunk(engine.LUEngine, kept, calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_relaxation(md, SolverConfig(basis_inverse="lu"), mesh=mesh)
    collectives = sharded.COLLECTIVES
    graph_counts = _graph_counts()
    window["mesh/lu"] = _launch_counts()
    _check("run_chunk" in kept,
           f"mesh/lu: the solve ended after {len(calls)} chunks, before {_PROFILED_CHUNK}")
    prefix_s = calls[_PROFILED_CHUNK - 1] - t0
    state = kept["run_chunk"][0][1]
    pivots = int(state.iteration)
    _check(pivots == int(ref.iteration),
           f"mesh/lu: {pivots} pivots before chunk {_PROFILED_CHUNK}, lu/real {int(ref.iteration)}")
    _check(torch.equal(state.basis, ref.basis) and int(state.status) == int(ref.status),
           f"mesh/lu: another basis or status than lu/real's before chunk {_PROFILED_CHUNK}")
    replay = _Replay(torch, "mesh/lu", kept, calls)
    _check(kept["run_chunk"][0][0].shard is not None,
           "mesh/lu: the LU engine ran without its shard")
    _line(
        "mesh/lu", problem="main/real", mesh="1x1", basis_inverse="lu",
        prefix_chunks=_PROFILED_CHUNK - 1, same_basis=True, same_status=True,
        pivots=pivots, lu_real_pivots=int(ref.iteration),
        collectives=collectives, collectives_per_pivot=f"{collectives / pivots:.3f}",
        prefix_s=f"{prefix_s:.3f}", prefix_ms_per_pivot=f"{prefix_s / pivots * 1e3:.4f}",
        lu_real_prefix_ms_per_pivot=f"{lu['prefix_s'] / pivots * 1e3:.4f}",
        graphs=_graph_fields(graph_counts), **_CARD,
    )
    _split_line("mesh/lu/split", split, prefix_s, pivots)
    _line(
        "mesh/lu", profiled_chunk=_PROFILED_CHUNK, path="graph",
        chunk_collectives_per_pivot=f"{replay.collectives / replay.pivots:.3f}",
        **replay.fields(),
        lu_real_chunk_ms_per_pivot=f"{lu['replay'].ms_per_pivot:.4f}",
        lu_real_launches_per_pivot=f"{lu['replay'].launches_per_pivot:.1f}",
        lu_real_host_launches_per_pivot=f"{lu['replay'].host_launches_per_pivot:.3f}",
    )


def phase_mesh_world1(torch, np, device, main_result, window, lu):
    """The mesh (relp_tpu_torch.parallel) as a world of one over NCCL: one
    card shows the sharded code and its collectives, not a scale-out.
    initialize_multihost() with no torchrun environment, make_mesh((1, 1));
    every loop replays captured graphs, collectives inside.  main/real
    through solve_relaxation(mesh=...): main/real's basis, pivots and
    digest; the resident family through solve_batch(mesh=...), three
    times, which takes the batched torch path: every LP certified, the family's
    digest, the same bases; first_order/pdhg's LP through
    pdhg_solve(mesh=...) against the same call unsharded (4,000 iterations
    each): the same iterations, the objective within
    _MESH_PDHG_OBJECTIVE_REL, the iterates x and y within _MESH_PDHG_X_REL
    and _MESH_PDHG_Y_REL (relative to their largest entry) and the primal
    residual within twice the unsharded one; and against itself with its
    chunks eager, bit for bit; collectives and ms per pivot of the sharded
    chunk loop, eager and graphed (the same bits), beside the unsharded
    one at the chunk loop's problem.  The path's launch counts
    (``window["mesh/world1"]``) cover the mesh solves only: the unsharded
    runs, the eager PDHG check and the timing loops run outside that
    window.  Then mesh/lu (``phase_mesh_lu``, with
    its own window) in the same world; the process group is destroyed at
    the end.  Returns the scan kernel's check on the inputs this path gave
    it."""
    import torch.distributed as dist

    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.firstorder import pdhg
    from relp_tpu_torch.ops import batch_pivot
    from relp_tpu_torch.parallel import (
        column_shard,
        initialize_multihost,
        make_mesh,
        shard_state,
        sharded,
        sharded_run_chunk,
        shutdown_multihost,
        solve_batch,
    )
    from relp_tpu_torch.simplex import SolveStatus, graphs, kernels, solve_relaxation
    from relp_tpu_torch.testing import (
        FAMILIES,
        FAMILY_OBJECTIVES_SHA256,
        PDHG_SIZE,
        REAL_SIZE,
        REAL_SIZE_OBJECTIVE_SHA256,
        generated_lp,
        objectives_digest,
        pdhg_lp,
        scenario_family,
    )
    from relp_tpu_torch.tools import pdhg_check

    # The chunk loop's problem, and its unsharded time before the process
    # group exists (NCCL's threads run beside the host from then on).
    state0, A_d, c_d, cand_d = _bench_chunk_inputs(torch, np, device)
    kw = dict(pricing=kernels.PRICE_STEEPEST, opt_tol=1e-7, pivot_tol=1e-7,
              degen_tol=1e-7)

    def timed(fn):
        def run(chunk):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pivots = int(fn(chunk).iteration)  # the sync inside the region
            return time.perf_counter() - t, pivots
        return run

    unsharded = timed(lambda ch: kernels.run_chunk(state0, A_d, A_d, c_d, cand_d,
                                                   chunk=ch, **kw))
    before_group = _marginal_ms_per_pivot(torch, np, {"unsharded": unsharded}, reps=2)

    initialize_multihost()
    kept = {}
    try:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        _check(dist.get_backend() == backend and dist.get_world_size() == 1,
               f"mesh/world1: {dist.get_backend()} world {dist.get_world_size()}")
        mesh = make_mesh((1, 1))

        # The unsharded PDHG run that the sharded one is held to, before
        # the path's launch window opens.
        A, b, c, u = pdhg_lp(**PDHG_SIZE)
        As, bs, cs, us, d_row, d_col = pdhg.scale_problem(A, b, c, u, np.float32)
        found = {}

        def pdhg_run(label, on):
            sharded.COLLECTIVES = 0
            x, y, st = pdhg.pdhg_solve(A, b, c, u, tol=1e-6, max_iters=_MESH_PDHG_ITERS,
                                       dtype=np.float32, device=device, mesh=on)
            found[label] = dict(
                st=st, collectives=sharded.COLLECTIVES, objective=float(c @ x), x=x, y=y,
                kkt=pdhg_check.kkt64(As, bs, cs, us, x / d_col, y / d_row))

        pdhg_run("unsharded", None)

        # The path: main/real, column-sharded over a "col" axis of one rank.
        _zero_launch_counts()
        gf = generated_lp(**REAL_SIZE)
        gf.presolve()
        md = gf.derive_matrix_data(gf.standardize())
        sharded.COLLECTIVES = 0
        graphs0 = _graph_counts()
        with _keeping_inputs(kernels, "fused_price_scan", kept):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = solve_relaxation(md, SolverConfig(), mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        collectives = sharded.COLLECTIVES
        graph_counts = {k: v - graphs0[k] for k, v in _graph_counts().items()}
        _check(graph_counts["replays"] == result.stats.chunks,
               f"mesh/world1: {graph_counts['replays']} replays for {result.stats.chunks} chunks")
        _check(result.status is SolveStatus.FINITE_OPTIMUM and result.stats.certified,
               f"mesh/world1 main/real: {result.status}")
        digest = hashlib.sha256(
            str(_reconstructed_objective(gf, md, result)).encode()).hexdigest()
        _check(digest == REAL_SIZE_OBJECTIVE_SHA256, f"mesh/world1 digest {digest}")
        _check(result.basis == main_result.basis, "mesh/world1: another basis than main/real")
        pivots = result.stats.iterations
        _check(pivots == main_result.stats.iterations,
               f"mesh/world1: {pivots} pivots, main/real {main_result.stats.iterations}")
        solve_s = result.stats.wall_time_s - result.stats.certify_time_s
        _line(
            "mesh/world1", problem="main/real", backend=backend, mesh="1x1",
            status=result.status.value, certified=True, digest_ok=True,
            same_basis=True, pivots=pivots, main_real_pivots=main_result.stats.iterations,
            chunks=result.stats.chunks, collectives=collectives,
            collectives_per_pivot=f"{collectives / pivots:.3f}",
            wall_s=f"{wall:.3f}", solve_s=f"{solve_s:.3f}",
            certify_s=f"{result.stats.certify_time_s:.3f}",
            certify_share=f"{result.stats.certify_time_s / wall:.3f}",
            solve_ms_per_pivot=f"{solve_s / pivots * 1e3:.4f}",
            graphs=_graph_fields(graph_counts), **_CARD,
        )

        # The resident family: the batch sharded over "batch" and "col",
        # three times: a key runs eagerly at its first use and is captured
        # at its second, so the second call captures what the first took
        # once, and the third only replays.
        fam = FAMILIES["resident"]
        bases = []
        for call in (1, 2, 3):
            before = batch_pivot.LAUNCHES_RESIDENT + batch_pivot.LAUNCHES_BLOCKED
            sharded.COLLECTIVES = 0
            graphs0 = _graph_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = solve_batch(scenario_family(**fam), _batch_config(), certify=True,
                                  shared_structure=True, mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            graph_counts = {k: v - graphs0[k] for k, v in _graph_counts().items()}
            bad = [k for k, r in enumerate(results)
                   if r.status is not SolveStatus.FINITE_OPTIMUM or not r.stats.certified]
            _check(not bad, f"mesh/world1 resident family: not certified {bad[:10]}")
            digest = objectives_digest(r.exact_objective for r in results)
            _check(digest == FAMILY_OBJECTIVES_SHA256["resident"],
                   f"mesh/world1 resident family digest {digest}")
            launched = batch_pivot.LAUNCHES_RESIDENT + batch_pivot.LAUNCHES_BLOCKED - before
            _check(launched == 0, "mesh/world1: a batched-pivot kernel ran under a mesh")
            bases.append([r.basis for r in results])
            _check(bases[-1] == bases[0], f"mesh/world1: the resident call {call}'s bases "
                                          "differ from the first call's")
            _check(call == 1 or graph_counts["replays"] > 0,
                   f"mesh/world1 resident family: call {call} replayed no step")
            _check(call < 3 or graph_counts["captures"] == 0,
                   "mesh/world1 resident family: the third call captured")
            _line(
                "mesh/world1", problem="batch/resident", call=call, scenarios=len(results),
                path="batched torch", certified=len(results), digest_ok=True,
                same_bases=True, fallbacks=sum(bool(r.stats.batch_fallback) for r in results),
                pivots=sum(r.stats.iterations for r in results),
                collectives=sharded.COLLECTIVES, wall_s=f"{wall:.3f}",
                certify_s=f"{sum(r.stats.certify_time_s for r in results):.3f}",
                device_solve_s=f"{max(r.stats.wall_time_s for r in results):.3f}",
                graphs=_graph_fields(graph_counts),
                graph_evictions=graph_counts["evictions"],
                **_step_cache_fields(mesh.get_group("col")),
            )

        # first_order/pdhg's LP, rows over "batch" and columns over "col";
        # the path's window closes after it.
        graphs0 = _graph_counts()
        pdhg_run("sharded", mesh)
        pdhg_graphs = {k: v - graphs0[k] for k, v in _graph_counts().items()}
        window["mesh/world1"] = _launch_counts()
        # The same call with its chunks eager: the graphed point's bits.
        keep = graphs.DEVICE_TYPES
        graphs.DEVICE_TYPES = ()
        try:
            pdhg_run("sharded_eager", mesh)
        finally:
            graphs.DEVICE_TYPES = keep
        graphed_pdhg, eager_pdhg = found["sharded"], found["sharded_eager"]
        _check(graphed_pdhg["x"].tobytes() == eager_pdhg["x"].tobytes()
               and graphed_pdhg["y"].tobytes() == eager_pdhg["y"].tobytes()
               and graphed_pdhg["st"].iterations == eager_pdhg["st"].iterations
               and graphed_pdhg["st"].restarts == eager_pdhg["st"].restarts
               and graphed_pdhg["collectives"] == eager_pdhg["collectives"],
               "mesh/world1 pdhg: the graphed sharded run differs from the eager one")
        _check(pdhg_graphs["captures"] == 1
               and pdhg_graphs["replays"] == _MESH_PDHG_ITERS // 200,
               f"mesh/world1 pdhg: graphs {_graph_fields(pdhg_graphs)}")
        one, ref = found["sharded"], found["unsharded"]
        rel = abs(one["objective"] - ref["objective"]) / (1.0 + abs(ref["objective"]))
        x_rel, y_rel = (float(np.abs(one[v] - ref[v]).max() / (1.0 + np.abs(ref[v]).max()))
                        for v in ("x", "y"))
        _check(one["st"].iterations == ref["st"].iterations
               and rel <= _MESH_PDHG_OBJECTIVE_REL
               and x_rel <= _MESH_PDHG_X_REL and y_rel <= _MESH_PDHG_Y_REL
               and one["kkt"][0] <= 2.0 * ref["kkt"][0],
               f"mesh/world1 pdhg: {one['st'].iterations} iterations (unsharded "
               f"{ref['st'].iterations}), primal {one['kkt'][0]:.3e} (unsharded "
               f"{ref['kkt'][0]:.3e}), objective rel diff {rel:.2e}, x {x_rel:.2e}, "
               f"y {y_rel:.2e}")
        per_it = {k: v["st"].wall_time_s / v["st"].iterations * 1e3 for k, v in found.items()}
        _line(
            "mesh/world1", problem="first_order/pdhg", m=A.shape[0], n=A.shape[1],
            iterations=one["st"].iterations, restarts=one["st"].restarts,
            unsharded_restarts=ref["st"].restarts, collectives=one["collectives"],
            collectives_per_iteration=f"{one['collectives'] / one['st'].iterations:.3f}",
            graphs=_graph_fields(pdhg_graphs), graphed_point_bitwise_eager=True,
            ms_per_iteration=f"{per_it['sharded']:.4f}",
            eager_ms_per_iteration=f"{per_it['sharded_eager']:.4f}",
            unsharded_ms_per_iteration=f"{per_it['unsharded']:.4f}",
            primal_host_f64=f"{one['kkt'][0]:.4e}", unsharded_primal=f"{ref['kkt'][0]:.4e}",
            dual_host_f64=f"{one['kkt'][1]:.4e}", unsharded_dual=f"{ref['kkt'][1]:.4e}",
            objective_rel_diff=f"{rel:.2e}", x_rel_diff=f"{x_rel:.2e}",
            y_rel_diff=f"{y_rel:.2e}",
        )

        # The chunk loop at its bench problem, sharded against unsharded.
        shard = column_shard(mesh, A_d.shape[1], device)
        A_s, c_s, cand_s = shard.take(A_d), shard.take(c_d), shard.take(cand_d)
        state_s = shard_state(mesh, state0, A_d.shape[1])
        captured = graphs.ChunkGraphs()
        runs = {
            "unsharded": unsharded,
            "sharded": timed(lambda ch: sharded_run_chunk(
                shard, state_s, A_s, A_s, c_s, cand_s, chunk=ch, **kw)),
            "sharded_graph": timed(lambda ch: captured.run_chunk(
                state_s, A_s, A_s, c_s, cand_s, chunk=ch, shard=shard, **kw)),
        }
        per_pivot = _marginal_ms_per_pivot(torch, np, runs, reps=4)
        # The graphed sharded chunk against the eager one from the same
        # state: the same bits, and the collectives a replay counts (what
        # its capture counted) those of the eager chunk.
        profiled = {}
        for path in ("sharded", "sharded_graph"):
            sharded.COLLECTIVES = 0
            _t, chunk_pivots = runs[path](60)
            per_chunk = sharded.COLLECTIVES
            busy_ms, launches, _top, host = _device_busy(
                torch, lambda: runs[path](60), chunk_pivots)
            profiled[path] = dict(collectives=per_chunk, pivots=chunk_pivots,
                                  busy_ms=busy_ms, launches=launches,
                                  host=sum(host.values()))
        _check(profiled["sharded"]["collectives"] == profiled["sharded_graph"]["collectives"],
               f"mesh/chunk: collectives {profiled}")
        eager_state = sharded_run_chunk(shard, state_s, A_s, A_s, c_s, cand_s, chunk=60, **kw)
        graph_state = captured.run_chunk(state_s, A_s, A_s, c_s, cand_s, chunk=60,
                                         shard=shard, **kw)
        differ = [name for name, g, e in zip(eager_state._fields, graph_state, eager_state)
                  if not (g.dtype == e.dtype and torch.equal(
                      g.reshape(-1).view(torch.uint8), e.reshape(-1).view(torch.uint8)))]
        _check(not differ, f"mesh/chunk: the graphed sharded chunk differs in {differ}")
        chunk_pivots = profiled["sharded"]["pivots"]
        per_chunk = profiled["sharded"]["collectives"]
        busy_ms, launches = profiled["sharded"]["busy_ms"], profiled["sharded"]["launches"]
        idle = 1.0 - busy_ms / per_pivot["sharded"][0] if busy_ms else None
        graph = profiled["sharded_graph"]
        graph_busy_over_wall = graph["busy_ms"] / per_pivot["sharded_graph"][0]
        # The two collectives of a pivot alone: 200 calls each at the
        # chunk's sizes (the entering choice; the column with c_q and c_B).
        pick = torch.zeros(3, dtype=torch.float64, device=device)
        column = torch.zeros(2 * A_d.shape[0] + 1, dtype=A_d.dtype, device=device)
        collective_ms = {}
        for name, call in (("all_gather", lambda: sharded.all_gather(pick, shard.group, 1)),
                           ("all_reduce", lambda: sharded.all_reduce(column, shard.group))):
            call()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(200):
                call()
            torch.cuda.synchronize()
            collective_ms[name] = (time.perf_counter() - t) / 200 * 1e3
        _line(
            "mesh/chunk", shape="x".join(map(str, A_d.shape)), pricing="steepest",
            method="median of 4 interleaved (300-10)-pivot differences",
            sharded_ms_per_pivot=f"{per_pivot['sharded'][0]:.4f}",
            unsharded_ms_per_pivot=f"{per_pivot['unsharded'][0]:.4f}",
            unsharded_before_group_ms_per_pivot=f"{before_group['unsharded'][0]:.4f}",
            sharded_q1_q3="/".join(f"{q:.4f}" for q in per_pivot["sharded"][1:3]),
            unsharded_q1_q3="/".join(f"{q:.4f}" for q in per_pivot["unsharded"][1:3]),
            collectives_per_pivot=f"{per_chunk / chunk_pivots:.3f}",
            all_gather_ms=f"{collective_ms['all_gather']:.4f}",
            all_reduce_ms=f"{collective_ms['all_reduce']:.4f}",
            sharded_launches_per_pivot=f"{launches / chunk_pivots:.1f}",
            sharded_device_busy_ms_per_pivot=(f"{busy_ms:.4f}" if busy_ms
                                              else "not measured"),
            sharded_device_idle_share=f"{idle:.3f}" if idle is not None else "not measured",
            sharded_host_launches_per_pivot=(
                f"{profiled['sharded']['host'] / chunk_pivots:.3f}"),
            graph_ms_per_pivot=f"{per_pivot['sharded_graph'][0]:.4f}",
            graph_q1_q3="/".join(f"{q:.4f}" for q in per_pivot["sharded_graph"][1:3]),
            graph_bitwise_eager=True,
            graph_collectives_per_pivot=f"{graph['collectives'] / graph['pivots']:.3f}",
            graph_launches_per_pivot=f"{graph['launches'] / graph['pivots']:.1f}",
            graph_host_launches_per_pivot=f"{graph['host'] / graph['pivots']:.3f}",
            graph_device_busy_ms_per_pivot=(f"{graph['busy_ms']:.4f}" if graph["busy_ms"]
                                            else "not measured"),
            # The profiler traces every node of a graph: its busy time can
            # sum above the unprofiled wall time, and then no idle share.
            graph_device_idle_share=(f"{1.0 - graph_busy_over_wall:.3f}"
                                     if 0 < graph_busy_over_wall <= 1 else "not measured"),
            graph_captures=len(captured._entries), **_CARD,
        )
        _timed("mesh/lu", phase_mesh_lu, torch, mesh, lu, window)
    finally:
        shutdown_multihost()  # the group's captured steps, then the groups
    _check("fused_price_scan" in kept, "mesh/world1 never called the scan")

    return lambda: _replay_scan(torch, "mesh/kernel", kept["fused_price_scan"][0])


def phase_other_modes(torch, np, device, knap6_pivots, main_result):
    """The other solve modes, each path's launch counts from 0 just before
    it and read just after it (mesh/lu, run inside mesh/world1's process
    group, counts its own); then each kernel against its plain version
    on the inputs a path gave it (launches not counted): mip/real's, and
    the scan's on main/bf16, mip/real64, df32/real and mesh/world1.
    Returns ({path: launches by kernel}, {kernel: mip/real's error},
    {path: (the scan's error, its times)}, {eta-ring kernel: lu/kernel's
    fields})."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.simplex import engine

    by_path, replays, window, lu, df32, mip64 = {}, {}, {}, {}, {}, {}
    for path, run in (
        ("main/bf16", lambda: phase_main_real(
            torch, np, "main/bf16", "bfloat16", main_result,
            max_iterations=_MAIN_BF16_MAX_ITERATIONS)[1]),
        ("mip/small", lambda: phase_mip_small(knap6_pivots)),
        ("mip/real", lambda: phase_mip_real(torch, np)),
        ("mip/real64", lambda: phase_mip_real64(torch, np, mip64)),
        ("mip/real64/eager", lambda: phase_mip_real64_eager(torch, np, mip64)),
        ("first_order/real", lambda: phase_first_order_real(torch)),
        ("first_order/pdhg", lambda: phase_first_order_pdhg(torch, np, device)),
        ("lu/real", lambda: phase_lu_real(torch, lu)),
        ("lu/real/eager", lambda: phase_eager_prefix(
            torch, "lu/real", engine.LUEngine, SolverConfig(basis_inverse="lu"), lu)),
        ("df32/real", lambda: phase_df32_real(torch, np, df32)),
        ("df32/real/eager", lambda: phase_eager_prefix(
            torch, "df32/real", engine.DoubleFloatEngine, SolverConfig(carry="df32"), df32)),
        ("mesh/world1", lambda: phase_mesh_world1(torch, np, device, main_result,
                                                  window, lu)),
    ):
        _zero_launch_counts()
        replays[path] = _timed(path, run)
        # A phase that also runs what is not its path counts its own window.
        by_path[path] = window.pop(path) if path in window else _launch_counts()
        _line("launches", path=path, **by_path[path])
        for nested in list(window):  # a path run inside this phase
            by_path[nested] = window.pop(nested)
            _line("launches", path=nested, **by_path[nested])
    for path in ("main/bf16", "mip/small", "mip/real", "mip/real64", "df32/real",
                 "mesh/world1"):
        _check(by_path[path]["fused_price_scan"] > 0,
               f"{path} never launched the scan kernel")
    _check(by_path["main/bf16"]["fused_price_scan_bfloat16"] > 0,
           "main/bf16 never launched the scan kernel on its bf16 tableau")
    for path, names in (("lu/real", ("eta_ftran", "eta_btran_pair")),
                        ("lu/real/eager", ("eta_ftran", "eta_btran_pair")),
                        ("mesh/lu", ("eta_ftran", "eta_btran_pair")),
                        ("mip/small", ("eta_ftran", "eta_btran", "eta_btran_pair"))):
        for name in names:
            _check(by_path[path][name] > 0, f"{path} never launched {name}")
    scans = {path: replays[path]() for path in ("main/bf16", "mip/real64", "df32/real",
                                                 "mesh/world1")}
    mip = replays["mip/real"]()
    scans["mip/real"] = (mip["fused_price_scan"], mip.pop("fused_price_scan_times"))
    eta = _timed("lu/kernel", replays["lu/real"])
    return by_path, mip, scans, eta


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
    started = time.perf_counter()
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

    device = _timed("device", phase_device, torch)
    _timed("build", phase_build)
    main_shape, errors, times = _timed("kernel", phase_kernel, torch, np, device)
    probes = _timed("probe", phase_probe, torch, device)
    batch_errors, batch_times = _timed("batch/kernel", phase_batch_kernel, torch, np)

    # Counts from here on are the main path's.
    price_scan.LAUNCHES = 0
    price_scan.LAUNCHES_BY_DTYPE.update(dict.fromkeys(price_scan.LAUNCHES_BY_DTYPE, 0))
    knap6_pivots = _timed("main/small", phase_main_small, torch)
    main_result, main_replay = _timed("main/real", phase_main_real, torch, np)
    launches = price_scan.LAUNCHES
    _check(launches > 0, "the main path never launched the scan kernel")
    main_scan = main_replay()  # the kernel on main/real's inputs, not counted
    _timed("main/real/eager", phase_main_real_eager, torch, np, main_result)

    _timed("chunk", phase_chunk_loop, torch, np, device, times)
    differ = _timed("chunk/graph", phase_chunk_graph, torch, np, device)
    _check(not differ, f"chunk/graph: graphed chunks differ from eager ones: {differ}")

    # The scenario-batch path, once per family; the counts are each run's.
    batch_launches = {}
    for name, counter in (("resident", "LAUNCHES_RESIDENT"),
                          ("blocked", "LAUNCHES_BLOCKED")):
        batch_pivot.LAUNCHES_RESIDENT = batch_pivot.LAUNCHES_BLOCKED = 0
        _timed(f"batch/{name}", phase_batch_family, torch, np, name, FAMILIES[name],
               FAMILY_OBJECTIVES_SHA256[name])
        batch_launches[name] = getattr(batch_pivot, counter)
        _check(batch_launches[name] > 0,
               f"the {name} family never launched batch_pivot_kernel<{name}>")
    _timed("batch/memory", phase_batch_memory, torch)
    batch_pivot.LAUNCHES_RESIDENT = batch_pivot.LAUNCHES_BLOCKED = 0
    _timed("batch/warm", phase_batch_warm, torch, np)
    _timed("batch/chunk", phase_batch_chunk, torch, np)
    differ = _timed("batch/graph", phase_batch_graph, torch, np)
    _check(not differ, f"batch/graph: graphed steps differ from eager ones: {differ}")

    by_path, mip_errors, scans, eta = phase_other_modes(
        torch, np, device, knap6_pivots, main_result)
    scans = {"main/real": main_scan, **scans}
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in _REFUSED)
    _check(not loaded, f"imported: {loaded}")

    main_case = (*main_shape, torch.float32)
    scan = times[main_case]
    kernels = [{
        "name": "fused_price_scan",
        "route": "cuda",
        "source": "relp_tpu_torch/csrc/price_scan.cu",
        "replaces": "relp_tpu/ops/pallas_scan.py:102",
        "launches": launches,
        "max_abs_err": errors[main_case],
        **{f"{path.replace('/', '_')}_abs_err": err for path, (err, _t) in scans.items()},
        "ms": scan["kernel_ms"],
        "cold_ms": scan["kernel_cold_ms"],
        "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"],
        "library_ms": scan["matmul_ms"],
        "library_cold_ms": scan["matmul_cold_ms"],
        "library": "torch.matmul(P, A), TF32 off, without the d/gamma epilogue",
        "shape": list(main_shape),
        # Every shape and dtype of the kernel phase, and each path's inputs.
        "by_case": {f"{M}x{N} {str(dtype).replace('torch.', '')}": t
                    for (M, N, dtype), t in times.items()},
        "on_path_inputs": {path: t for path, (_err, t) in scans.items()},
        "launches_by_path_dtype": {
            path: {name: counts[f"fused_price_scan_{name}"]
                   for name in price_scan.LAUNCHES_BY_DTYPE}
            for path, counts in by_path.items()},
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
    # eta_ftran and the pair: lu/real's launches; eta_btran (one vector)
    # runs on no steepest-edge pivot, so its count is mip/small's (the LU
    # engine with Dantzig pricing).
    for name, line, path, per in (
        ("eta_ftran", "77", "lu/real", "one launch"),
        ("eta_btran", "98", "mip/small", "one launch of one vector (the pair's first)"),
        ("eta_btran_pair", "98", "lu/real",
         "one launch of two vectors, rho's and the Goldfarb BTRAN (its plain version "
         "two torch loops)"),
    ):
        fields = eta[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "relp_tpu_torch/csrc/eta_ring.cu",
            "replaces": f"relp_tpu/simplex/lu.py:{line} (XLA fori_loop, no Pallas)",
            "launches": by_path[path][name],
            "launches_from": path,
            "max_abs_err": fields["max_abs_err"],
            **({"rel_err_vs_matmul_loop": fields["rel_err_vs_matmul_loop"]}
               if name != "eta_ftran" else {}),
            "ms": fields["ms"],
            "cold_ms": fields["cold_ms"],
            "empty_ring_ms": fields["empty_ms"],
            "slot_chain_ms": fields["chain_ms"],
            "slot_chain_cold_ms": fields["chain_cold_ms"],
            "plain_ms": fields["plain_ms"],
            **({"ordered_plain_ms": fields["ordered_plain_ms"]}
               if name != "eta_ftran" else {}),
            "bound_ms": fields["bound_ms"],
            "bound_by": fields["bound_by"],
            "library_ms": None,
            "shape": fields["shape"],
            "live_slots": fields["live_slots"],
            "per": f"{per} on lu/real's 20th chunk's last call (plain: the torch loop "
                   "over the live slots, replayed from a graph)",
        })
    for entry in kernels:
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in by_path.items()}
    _line("time", total_s=f"{time.perf_counter() - started:.1f}")
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
