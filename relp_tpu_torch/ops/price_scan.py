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
the (M, N) tableau once for 6 M N flops.  One launch per call: the columns
are cut into tiles of 128-512 bytes of a row, the rows of a tile split over
the CTAs of a thread block cluster, each thread streaming its 16 bytes of
its rows through its own ring of shared-memory slots filled by 16-byte
``cp.async``; the cluster adds its partial sums through distributed shared
memory in rank order and applies the epilogue (the plain version's
operations, each rounded to the dtype), so it is deterministic and needs no
scratch in device memory.  It accumulates with plain FMAs in f32 (f32 and
bf16 inputs) or f64, never TF32.  It takes any M and N (``tiling`` chooses
the launch).

It is compiled at first use, with the port's other kernels, by
``relp_tpu_torch.ops._build`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from relp_tpu_torch.ops import _build

# Launches of the CUDA kernel since the last reset (one per call that reached
# the device); the plain version does not count.  LAUNCHES_BY_DTYPE splits
# the same launches by the tableau's dtype.
LAUNCHES = 0
LAUNCHES_BY_DTYPE: Dict[str, int] = {"float32": 0, "float64": 0, "bfloat16": 0}

_ENTRIES = {
    torch.float32: "relp_price_scan_f32",
    torch.float64: "relp_price_scan_f64",
    torch.bfloat16: "relp_price_scan_bf16",
}
# The largest cluster of the source.
MAX_CLUSTER = 8
# The choices of ``tiling`` (timed on the H100: PERF.md).
_SMALL_ROWS = 256  # up to this many rows: one CTA a tile, 128-byte tiles
_TARGET_CTAS = 320  # past it: about 2.5 CTAs an SM of the H100's 132
_MIN_ROWS_PER_RANK = 32  # a cluster rank takes at least this many rows
_LIB: Optional[ctypes.CDLL] = None


class Tiling(NamedTuple):
    """One launch of the kernel: column tiles of ``tile_cols`` columns, the
    rows of each split over ``cluster`` CTAs of ``rows_per_rank`` rows."""

    tile_cols: int
    cluster: int
    rows_per_rank: int


def tiling(M: int, N: int, itemsize: int) -> Tiling:
    """The launch for an (M, N) tableau of ``itemsize``-byte elements.

    Up to _SMALL_ROWS rows: one CTA a tile, tiles of 128 B
    (a row of 512 B or less in one tile).  Past that: tiles of 256 B, the
    cluster doubled (up to 8) while the CTAs number fewer than
    _TARGET_CTAS and each rank keeps at least _MIN_ROWS_PER_RANK rows."""
    row_bytes = N * itemsize
    if M <= _SMALL_ROWS:
        tile_bytes = 128
        while tile_bytes < 512 and tile_bytes < row_bytes <= 512:
            tile_bytes *= 2
        return Tiling(tile_bytes // itemsize, 1, M)
    tile_cols = 256 // itemsize
    tiles = -(-N // tile_cols)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * cluster < _TARGET_CTAS
           and M >= 2 * cluster * _MIN_ROWS_PER_RANK):
        cluster *= 2
    return Tiling(tile_cols, cluster, -(-M // cluster))


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.relp_price_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.relp_price_scan_smem_bytes.restype = ctypes.c_int
    _LIB = lib
    return lib


def smem_bytes(itemsize: int, t: Tiling) -> int:
    """Dynamic shared memory of a CTA of the launch ``t`` (from the source)."""
    return build().relp_price_scan_smem_bytes(itemsize, t.rows_per_rank)


def _launch(P, A, c, gamma, gamma_q, t: Optional[Tiling] = None):
    """The kernel on CUDA tensors, with ``tiling``'s launch unless ``t``
    names another (for timing the alternatives)."""
    global LAUNCHES
    M, N = A.shape
    dtype = A.dtype
    if dtype not in _ENTRIES:
        raise TypeError(f"fused_price_scan: unsupported dtype {dtype}")
    gamma_q = torch.as_tensor(gamma_q, dtype=dtype, device=A.device).reshape(())
    for name, x, shape in (
        ("P", P, (3, M)), ("c", c, (N,)), ("gamma", gamma, (N,)),
    ):
        if x.device != A.device or x.dtype != dtype:
            raise ValueError(
                f"fused_price_scan: {name} is {x.dtype} on {x.device}, "
                f"expected {dtype} on {A.device}"
            )
        if tuple(x.shape) != shape:
            raise ValueError(
                f"fused_price_scan: {name} has shape {tuple(x.shape)}, "
                f"expected {shape}"
            )
        if not x.is_contiguous():
            raise ValueError(f"fused_price_scan: {name} is not contiguous")
    if not A.is_contiguous():
        raise ValueError("fused_price_scan: A is not contiguous")
    if M < 1 or N < 1:
        raise ValueError(f"fused_price_scan: empty tableau {tuple(A.shape)}")
    lib = build()
    t = t or tiling(M, N, A.element_size())
    d = torch.empty(N, dtype=dtype, device=A.device)
    g = torch.empty(N, dtype=dtype, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = getattr(lib, _ENTRIES[dtype])(
            P.data_ptr(), A.data_ptr(), c.data_ptr(), gamma.data_ptr(),
            gamma_q.data_ptr(), d.data_ptr(), g.data_ptr(), M, N, *t, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_price_scan: CUDA launch failed (error {rc}, {t})")
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(dtype).replace("torch.", "")] += 1
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
