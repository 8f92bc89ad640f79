"""Fused steepest-edge pricing scan: the hand-written CUDA kernel and its
plain PyTorch version.

Replaces ``relp_tpu/ops/pallas_scan.py::fused_price_scan`` (Pallas body
``_scan_kernel``).  With P = [pi_new; v; rho] of shape (3, M):

    S     = P @ A
    d     = c - S[0]
    gamma' = max(gamma - 2 S[2] S[1] + S[2]^2 gamma_q, 1 + S[2]^2)

The gamma fixups at the entering and leaving columns stay with the caller
(relp_tpu_torch.simplex.kernels), as in the JAX package.

The kernel (``csrc/price_scan.cu``) is bound by memory bandwidth: it reads
the (M, N) tableau once for 6 M N flops.  It splits M over blocks and sums
the partials in fixed order, so it is deterministic, and it accumulates with
plain FMAs in f32 (f32 and bf16 inputs) or f64, never TF32.  It takes any N.

It is compiled at first use, with the port's other kernels, by
``relp_tpu_torch.ops._build`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from relp_tpu_torch.ops import _build

# Launches of the CUDA kernel since the last reset (one per call that reached
# the device); the plain version does not count.
LAUNCHES = 0

_ENTRIES = {
    torch.float32: "relp_price_scan_f32",
    torch.float64: "relp_price_scan_f64",
    torch.bfloat16: "relp_price_scan_bf16",
}
_ACC = {
    torch.float32: torch.float32,
    torch.float64: torch.float64,
    torch.bfloat16: torch.float32,
}
_THREADS = 256  # columns per block (kThreads in the source)
_TARGET_BLOCKS = 4 * 132  # a few waves over the H100's 132 SMs
_MIN_ROWS_PER_SPLIT = 32
_LIB: Optional[ctypes.CDLL] = None


def fused_price_scan_reference(P, A, c, gamma, gamma_q):
    """Plain PyTorch version (the formula of relp_tpu kernels.py:285-290)."""
    S = torch.matmul(P, A)
    d = c - S[0]
    inner = S[1]
    abar = S[2]
    g = gamma - 2.0 * abar * inner + (abar * abar) * gamma_q
    return d, torch.maximum(g, 1.0 + abar * abar)


def build() -> ctypes.CDLL:
    """The port's kernel library (built at first use), with this kernel's
    entry points declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.build()
    for name in _ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def _splits(M: int, N: int):
    """Row splits so that the grid holds a few waves of blocks."""
    col_blocks = -(-N // _THREADS)
    want = max(1, -(-_TARGET_BLOCKS // col_blocks))
    most = max(1, M // _MIN_ROWS_PER_SPLIT)
    rows_per_split = -(-M // min(want, most))
    return -(-M // rows_per_split), rows_per_split


def _launch(P, A, c, gamma, gamma_q):
    global LAUNCHES
    M, N = A.shape
    dtype = A.dtype
    if dtype not in _ENTRIES:
        raise TypeError(f"fused_price_scan: unsupported dtype {dtype}")
    gamma_q = torch.as_tensor(gamma_q, dtype=dtype, device=A.device).reshape(())
    for name, t, shape in (
        ("P", P, (3, M)), ("c", c, (N,)), ("gamma", gamma, (N,)),
    ):
        if t.device != A.device or t.dtype != dtype:
            raise ValueError(
                f"fused_price_scan: {name} is {t.dtype} on {t.device}, "
                f"expected {dtype} on {A.device}"
            )
        if tuple(t.shape) != shape:
            raise ValueError(
                f"fused_price_scan: {name} has shape {tuple(t.shape)}, "
                f"expected {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_price_scan: {name} is not contiguous")
    if not A.is_contiguous():
        raise ValueError("fused_price_scan: A is not contiguous")
    if M < 1 or N < 1:
        raise ValueError(f"fused_price_scan: empty tableau {tuple(A.shape)}")
    lib = build()
    splits, rows_per_split = _splits(M, N)
    d = torch.empty(N, dtype=dtype, device=A.device)
    g = torch.empty(N, dtype=dtype, device=A.device)
    partial = torch.empty((3, splits, N), dtype=_ACC[dtype], device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = getattr(lib, _ENTRIES[dtype])(
            P.data_ptr(), A.data_ptr(), c.data_ptr(), gamma.data_ptr(),
            gamma_q.data_ptr(), d.data_ptr(), g.data_ptr(), partial.data_ptr(),
            M, N, splits, rows_per_split, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_price_scan: CUDA launch failed (error {rc})")
    LAUNCHES += 1
    return d, g


def fused_price_scan(P, A, c, gamma, gamma_q):
    """Fused (d_next, gamma_new) scan; gamma_new is before the entering and
    leaving column fixups.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise on anything it does not take.
    """
    if A.device.type == "cpu":
        return fused_price_scan_reference(P, A, c, gamma, gamma_q)
    if A.device.type != "cuda":
        raise ValueError(f"fused_price_scan: unsupported device {A.device}")
    return _launch(P, A, c, gamma, gamma_q)
