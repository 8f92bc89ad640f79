"""Batched-pivot chunk kernels: the hand-written CUDA kernels and their
plain PyTorch version.

Replaces the two Pallas megakernels of ``relp_tpu/ops/pallas_batch.py``:

* :func:`batched_pivot_chunk` ("resident", ``batched_pivot_chunk`` there,
  ``pl.pallas_call`` at :865): one CUDA block per LP runs up to ``chunk``
  steepest-edge pivots with the LP's (M, M) inverse and all its vector
  state in shared memory;
* :func:`batched_pivot_chunk_blocked` ("blocked", ``pl.pallas_call`` at
  :724): the same pivots with the inverse in device memory, updated in
  place, for shapes whose inverse does not fit a block's shared memory.

Both take and return what the JAX functions do: (A, c, cand, Binv, xB, pi,
basis, in_basis, gamma, status, iteration, degen) in, the nine arrays
(Binv, xB, pi, basis, in_basis, gamma, status, iteration, degen) out.  They
compute the unguarded semantics (the TPU kernels' ``noise_eps`` = 0, no
``hi_scan``): this card's f32 products are true f32.

What bounds them on the H100: per pivot, one LP reads its tableau once
(M N 4 bytes) and its inverse two to three times, and one block per LP
uses at most B of the 132 SMs.  The resident variant keeps the inverse out
of device memory for the whole chunk; both read the tableau straight from
device memory, coalesced, and a family's tableaus stay largely in the
50 MB L2 when they fit (``csrc/batch_pivot.cu`` has the details).

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
_RED_WORDS = 128  # kRedWords in the source
_ENTRIES = {True: "relp_batch_pivot_resident", False: "relp_batch_pivot_blocked"}
_LIB: Optional[ctypes.CDLL] = None


def smem_bytes(M: int, N: int, *, resident: bool) -> int:
    """Shared memory of one block (csrc/batch_pivot.cu smem_bytes): the
    inverse when resident, eight M-vectors, three N-vectors of floats, the
    reduction scratch and two N-byte masks, rounded up to 16."""
    words = (M * M if resident else 0) + 8 * M + 3 * N + _RED_WORDS
    return -(-(4 * words + 2 * N) // 16) * 16


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build()
        for name in _ENTRIES.values():
            fn = getattr(lib, name)
            fn.argtypes = (
                [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def batched_pivot_chunk_reference(
    A, c, cand, Binv, xB, pi, basis, in_basis, gamma, status, iteration,
    degen, *, chunk: int, opt_tol: float, pivot_tol: float, degen_tol: float,
    stop_at_zero: bool = False,
):
    """Plain PyTorch version: ``batched_run_chunk`` with steepest pricing from
    the state the arguments give (obj = cB . xB, as the kernels compute it)."""
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
        stop_at_zero=stop_at_zero,
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
    if not t.is_contiguous():
        raise ValueError(f"batched_pivot_chunk: {name} is not contiguous")


def _launch(resident, A, c, cand, Binv, xB, pi, basis, in_basis, gamma,
            status, iteration, degen, chunk, opt_tol, pivot_tol, degen_tol,
            stop_at_zero):
    global LAUNCHES_RESIDENT, LAUNCHES_BLOCKED
    if A.dim() != 3:
        raise ValueError(f"batched_pivot_chunk: A has shape {tuple(A.shape)}")
    B, M, N = A.shape
    if B < 1 or M < 1 or N < 1:
        raise ValueError(f"batched_pivot_chunk: empty batch {tuple(A.shape)}")
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
    smem = smem_bytes(M, N, resident=resident)
    if smem > SMEM_LIMIT:
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
            A.data_ptr(), c.data_ptr(), cand.data_ptr(),
            *(t.data_ptr() for t in outs),
            B, M, N, int(chunk), float(opt_tol), float(pivot_tol),
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
         noise_eps, hi_scan):
    if noise_eps or hi_scan:
        raise ValueError(
            "batched_pivot_chunk: only the unguarded semantics (noise_eps=0, "
            "hi_scan=False) are ported; f32 products on CUDA are true f32"
        )
    A = args[0]
    if A.device.type == "cpu":
        return batched_pivot_chunk_reference(
            *args, chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, stop_at_zero=stop_at_zero,
        )
    if A.device.type != "cuda":
        raise ValueError(f"batched_pivot_chunk: unsupported device {A.device}")
    return _launch(resident, *args, chunk, opt_tol, pivot_tol, degen_tol,
                   stop_at_zero)


def batched_pivot_chunk(
    A, c, cand, Binv, xB, pi, basis, in_basis, gamma, status, iteration,
    degen, *, chunk: int, opt_tol: float, pivot_tol: float, degen_tol: float,
    stop_at_zero: bool = False, noise_eps: float = 0.0, hi_scan: bool = False,
):
    """Up to ``chunk`` steepest-edge pivots of every LP, inverse resident in
    shared memory.  ``noise_eps`` and ``hi_scan`` are the JAX function's;
    only 0 and False are taken."""
    return _run(True, (A, c, cand, Binv, xB, pi, basis, in_basis, gamma,
                       status, iteration, degen),
                chunk, opt_tol, pivot_tol, degen_tol, stop_at_zero,
                noise_eps, hi_scan)


def batched_pivot_chunk_blocked(
    A, c, cand, Binv, xB, pi, basis, in_basis, gamma, status, iteration,
    degen, *, chunk: int, opt_tol: float, pivot_tol: float, degen_tol: float,
    stop_at_zero: bool = False, noise_eps: float = 0.0, hi_scan: bool = False,
):
    """As :func:`batched_pivot_chunk`, with the inverse in device memory:
    for M whose (M, M) inverse does not fit a block's shared memory."""
    return _run(False, (A, c, cand, Binv, xB, pi, basis, in_basis, gamma,
                        status, iteration, degen),
                chunk, opt_tol, pivot_tol, degen_tol, stop_at_zero,
                noise_eps, hi_scan)
