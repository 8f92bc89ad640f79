"""Batched-pivot chunk kernels: the hand-written CUDA kernels and their
plain PyTorch version.

Replaces the two Pallas megakernels of ``relp_tpu/ops/pallas_batch.py``:

* :func:`batched_pivot_chunk` ("resident", ``batched_pivot_chunk`` there,
  ``pl.pallas_call`` at :865): one CUDA block per LP runs up to ``chunk``
  steepest-edge pivots with the LP's (M, M) inverse and all its vector
  state in shared memory;
* :func:`batched_pivot_chunk_blocked` ("blocked", ``pl.pallas_call`` at
  :724): the same pivots with the first rows of the inverse in shared
  memory and the rest in device memory, streamed through a ring of tiles
  and updated in place, for shapes whose inverse does not fit a block's
  shared memory.

Both take and return what the JAX functions do: (A, c, cand, Binv, xB, pi,
basis, in_basis, gamma, status, iteration, degen) in, the nine arrays
(Binv, xB, pi, basis, in_basis, gamma, status, iteration, degen) out.  They
compute the unguarded semantics (the TPU kernels' ``noise_eps`` = 0, no
``hi_scan``): this card's f32 products are true f32.

``A`` is either B stacked tableaus (batch stride M N) or one (M, N)
tableau expanded over the batch (batch stride 0), as ``solve_batch`` hands
out a shared-structure batch; any other layout raises.

What bounds them on the H100: per pivot, one LP reads the tableau once
(M N 4 bytes; from L2 when the batch shares one) and its inverse three
times (FTRAN, then one fused pass that reads and writes it), and one block
per LP uses at most B of the 132 SMs (``csrc/batch_pivot.cu`` has the
details).

:func:`batched_pivot_chunk_reference` is the plain version: the port's
``batched_run_chunk`` with steepest pricing, as ``tests/test_pallas_batch.py``
holds the Pallas kernels against the JAX batched path.  CPU tensors take it;
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from relp_tpu_torch.ops import _build

# Launches of each CUDA kernel since the last reset (one per call that
# reached the device); the plain version does not count.
LAUNCHES_RESIDENT = 0
LAUNCHES_BLOCKED = 0

# cudaDevAttrMaxSharedMemoryPerBlockOptin of the H100 (sm_90): 227 KB of the
# SM's 256 KB, the most one block may ask for as dynamic shared memory.
SMEM_LIMIT = 232_448
# Constants of the source: Launch<resident>::kThreads, kRedWords, kStages.
_THREADS = {True: 256, False: 1024}
_RED_WORDS = 136
_STAGES = 5
_ENTRIES = {True: "relp_batch_pivot_resident", False: "relp_batch_pivot_blocked"}
_LIB: Optional[ctypes.CDLL] = None


def _bytes(M: int, N: int, R: int, threads: int) -> int:
    """Shared memory of one block of ``threads`` with R inverse rows kept in
    it (csrc/batch_pivot.cu make_shape and smem_bytes): the R rows; a ring
    of 5 tiles of T = min(M, 4 threads // M) rows (one float4 a thread)
    when R < M; eight M-vectors and three N-vectors of floats; 136
    reduction words; the work scratch, the largest of the scan's partials
    (Gs - 1) 3 N with Gs = min(M, threads // (N / 4)) row groups (1 when
    N / 4 >= threads), the sum of v's (T + H) M with H = max(1, min(T,
    threads // M)), and FTRAN's M ceil(M / 128); two N-byte masks; rounded
    up to 16."""
    Qn = N // 4
    T = min(M, max(1, 4 * threads // M))
    Sg = -(-(M // 4) // 32)
    Gs = 1 if Qn >= threads else min(M, threads // Qn)
    H = max(1, min(T, threads // M))
    scratch = max((Gs - 1) * 3 * N, (T + H) * M, M * Sg)
    ring = _STAGES * T * M if R < M else 0
    words = R * M + ring + 8 * M + 3 * N + _RED_WORDS + scratch
    return -(-(4 * words + 2 * N) // 16) * 16


def blocked_rows(M: int, N: int) -> Optional[int]:
    """Inverse rows the blocked kernel keeps in shared memory: as many as
    fit beside the ring and the vector state (at most M), or None when not
    even the ring and the vectors fit."""
    base = _bytes(M, N, 0, _THREADS[False])
    if base > SMEM_LIMIT:
        return None
    return min(M, (SMEM_LIMIT - base) // (4 * M))


def smem_bytes(M: int, N: int, *, resident: bool) -> int:
    """Shared memory of one block: the whole inverse when resident (a
    256-thread block), else ``blocked_rows`` of it beside the ring (a
    1024-thread block; no rows when not even that fits, so the bytes then
    exceed ``SMEM_LIMIT``)."""
    R = M if resident else (blocked_rows(M, N) or 0)
    return _bytes(M, N, R, _THREADS[resident])


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build()
        for name in _ENTRIES.values():
            fn = getattr(lib, name)
            fn.argtypes = (
                [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 11
                + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
                + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def batched_pivot_chunk_reference(
    A, c, cand, Binv, xB, pi, basis, in_basis, gamma, status, iteration,
    degen, *, chunk: int, opt_tol: float, pivot_tol: float, degen_tol: float,
    stop_at_zero: bool = False, early_exit: Optional[bool] = None,
):
    """Plain PyTorch version: ``batched_run_chunk`` with steepest pricing from
    the state the arguments give (obj = cB . xB, as the kernels compute it).
    ``early_exit`` as in ``batched_run_chunk`` (False inside a captured
    step: the same result, no host read)."""
    from relp_tpu_torch.parallel.batch import batched_run_chunk
    from relp_tpu_torch.simplex.kernels import PRICE_STEEPEST
    from relp_tpu_torch.simplex.state import SimplexState

    cB = torch.take_along_dim(c, basis.to(torch.int64), dim=1)
    zeros = torch.zeros_like(status)
    state = SimplexState(
        Binv=Binv, basis=basis, xB=xB, pi=pi, obj=(cB * xB).sum(dim=1),
        in_basis=in_basis, gamma=gamma, iteration=iteration, status=status,
        degen_count=degen, inner=zeros, price_start=zeros,
        d=torch.zeros_like(c),
    )
    out = batched_run_chunk(
        state, A, A, c, cand, pricing=PRICE_STEEPEST, chunk=chunk,
        opt_tol=opt_tol, pivot_tol=pivot_tol, degen_tol=degen_tol,
        stop_at_zero=stop_at_zero, early_exit=early_exit,
    )
    return (out.Binv, out.xB, out.pi, out.basis, out.in_basis, out.gamma,
            out.status, out.iteration, out.degen_count)


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(
            f"batched_pivot_chunk: {name} is {t.dtype} on {t.device}, "
            f"expected {dtype} on {device}"
        )
    if tuple(t.shape) != shape:
        raise ValueError(
            f"batched_pivot_chunk: {name} has shape {tuple(t.shape)}, "
            f"expected {shape}"
        )
    if name != "A" and not t.is_contiguous():
        raise ValueError(f"batched_pivot_chunk: {name} is not contiguous")


def a_batch_stride(A: torch.Tensor) -> int:
    """The batch stride of a (B, M, N) tableau the kernels take: M N for B
    stacked tableaus, 0 for one tableau expanded over the batch.  Any other
    layout raises, as does a start off a 16-byte boundary (float4 reads)."""
    if A.dim() != 3:
        raise ValueError(f"batched_pivot_chunk: A has shape {tuple(A.shape)}")
    B, M, N = A.shape
    stride = A.stride()
    if stride[1:] != (N, 1) or (B > 1 and stride[0] not in (0, M * N)):
        raise ValueError(
            f"batched_pivot_chunk: A has strides {stride}; the kernels take "
            f"B stacked tableaus ({M * N}, {N}, 1) or one expanded (0, {N}, 1)"
        )
    if A.data_ptr() % 16:
        raise ValueError("batched_pivot_chunk: A does not start on 16 bytes")
    return 0 if B > 1 and stride[0] == 0 else M * N


def _launch(resident, A, c, cand, Binv, xB, pi, basis, in_basis, gamma,
            status, iteration, degen, chunk, opt_tol, pivot_tol, degen_tol,
            stop_at_zero):
    global LAUNCHES_RESIDENT, LAUNCHES_BLOCKED
    a_stride = a_batch_stride(A)
    B, M, N = A.shape
    if B < 1 or M < 1 or N < 1:
        raise ValueError(f"batched_pivot_chunk: empty batch {tuple(A.shape)}")
    threads = _THREADS[resident]
    if M % 4 or N % 4 or M > 4 * threads:
        raise ValueError(
            f"batched_pivot_chunk: the kernel takes M and N multiples of 4 "
            f"and M <= {4 * threads}, not M={M}, N={N}"
        )
    dev = A.device
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("A", A, f32, (B, M, N)), ("c", c, f32, (B, N)),
        ("cand", cand, torch.bool, (B, N)), ("Binv", Binv, f32, (B, M, M)),
        ("xB", xB, f32, (B, M)), ("pi", pi, f32, (B, M)),
        ("basis", basis, i32, (B, M)), ("in_basis", in_basis, torch.bool, (B, N)),
        ("gamma", gamma, f32, (B, N)), ("status", status, i32, (B,)),
        ("iteration", iteration, i32, (B,)), ("degen", degen, i32, (B,)),
    ):
        _check(name, t, dtype, shape, dev)
    R = M if resident else blocked_rows(M, N)
    smem = _bytes(M, N, R or 0, threads)
    if R is None or smem > SMEM_LIMIT:
        raise ValueError(
            f"batched_pivot_chunk: the {'resident' if resident else 'blocked'} "
            f"kernel needs {smem} bytes of shared memory at M={M}, N={N} "
            f"(limit {SMEM_LIMIT})"
        )
    # The kernel updates its outputs in place: they start as copies.
    outs = [t.clone() for t in (Binv, xB, pi, basis, in_basis, gamma, status,
                                iteration, degen)]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _ENTRIES[resident])(
            A.data_ptr(), a_stride, c.data_ptr(), cand.data_ptr(),
            *(t.data_ptr() for t in outs),
            B, M, N, R, int(chunk), float(opt_tol), float(pivot_tol),
            float(degen_tol), int(bool(stop_at_zero)), smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"batched_pivot_chunk: CUDA launch failed (error {rc})")
    if resident:
        LAUNCHES_RESIDENT += 1
    else:
        LAUNCHES_BLOCKED += 1
    return tuple(outs)


def _run(resident, args, chunk, opt_tol, pivot_tol, degen_tol, stop_at_zero,
         noise_eps, hi_scan, early_exit):
    if noise_eps or hi_scan:
        raise ValueError(
            "batched_pivot_chunk: only the unguarded semantics (noise_eps=0, "
            "hi_scan=False) are ported; f32 products on CUDA are true f32"
        )
    A = args[0]
    if A.device.type == "cpu":
        return batched_pivot_chunk_reference(
            *args, chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, stop_at_zero=stop_at_zero, early_exit=early_exit,
        )
    if A.device.type != "cuda":
        raise ValueError(f"batched_pivot_chunk: unsupported device {A.device}")
    return _launch(resident, *args, chunk, opt_tol, pivot_tol, degen_tol,
                   stop_at_zero)


def batched_pivot_chunk(
    A, c, cand, Binv, xB, pi, basis, in_basis, gamma, status, iteration,
    degen, *, chunk: int, opt_tol: float, pivot_tol: float, degen_tol: float,
    stop_at_zero: bool = False, noise_eps: float = 0.0, hi_scan: bool = False,
    early_exit: Optional[bool] = None,
):
    """Up to ``chunk`` steepest-edge pivots of every LP, inverse resident in
    shared memory.  ``noise_eps`` and ``hi_scan`` are the JAX function's;
    only 0 and False are taken.  ``early_exit`` is the plain version's (CPU
    tensors), as in ``batched_run_chunk``; the kernel reads nothing on the
    host."""
    return _run(True, (A, c, cand, Binv, xB, pi, basis, in_basis, gamma,
                       status, iteration, degen),
                chunk, opt_tol, pivot_tol, degen_tol, stop_at_zero,
                noise_eps, hi_scan, early_exit)


def batched_pivot_chunk_blocked(
    A, c, cand, Binv, xB, pi, basis, in_basis, gamma, status, iteration,
    degen, *, chunk: int, opt_tol: float, pivot_tol: float, degen_tol: float,
    stop_at_zero: bool = False, noise_eps: float = 0.0, hi_scan: bool = False,
    early_exit: Optional[bool] = None,
):
    """As :func:`batched_pivot_chunk`, with the inverse in device memory:
    for M whose (M, M) inverse does not fit a block's shared memory.  Its
    first ``blocked_rows`` rows stay in shared memory for the chunk, the
    others stream through a ring of tiles."""
    return _run(False, (A, c, cand, Binv, xB, pi, basis, in_basis, gamma,
                        status, iteration, degen),
                chunk, opt_tol, pivot_tol, degen_tol, stop_at_zero,
                noise_eps, hi_scan, early_exit)
