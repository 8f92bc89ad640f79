"""The LU engine's eta ring, FTRAN and BTRAN: the hand-written CUDA kernels
(one launch a pass) and their plain PyTorch versions.

Replaces no Pallas kernel: the JAX package applies the ring with two
``lax.fori_loop``s, ``relp_tpu/simplex/lu.py:77`` (``_apply_etas_ftran``)
and ``:98`` (``_apply_etas_btran``), which XLA compiles into one device
loop inside the jitted ``lu_run_chunk``.  The ring holds K slots; slot k is
the product-form eta (w_k, r_k), w_k = ``eta_vals[k]``, r_k =
``eta_rows[k]``, and the slots below ``eta_count`` are live:

    FTRAN  x <- E_n^-1 ... E_1^-1 x:  for k = 0 .. n-1,
           f = x[r] / w[r];  x <- x - f w;  x[r] <- f
    BTRAN  y <- y E_n^-1 ... E_1^-1:  for k = n-1 .. 0,
           y[r] <- y[r] - (y.w - y[r]) / w[r]

with n = min(eta_count, K).

* ``eta_ftran_plain`` / ``eta_btran_plain``: the plain loops, a few torch
  ops a slot.  With ``steps`` they run the first ``steps`` slots, each
  masked by ``k < eta_count`` (a slot past the live count is an identity,
  so any ``steps`` at or above the live count gives the same bits); the
  CPU route of ``simplex.lu`` passes the slots that can be live, as it
  always has.  BTRAN's dot is ``torch.matmul`` (``order="matmul"``, whose
  summation order the library chooses) or ``block_dot``
  (``order="kernel"``, the kernel's order).
* ``eta_ftran`` / ``eta_btran``: on CUDA tensors (``launches_kernel``)
  one launch of ``csrc/eta_ring.cu``, which reads ``eta_count`` on the
  device, so the pass has no host read and no length set on the host; it
  gives the bits of ``eta_ftran_plain`` and of ``eta_btran_plain(...,
  order="kernel")``.  On CPU tensors the plain loops run over ``steps``
  slots, BTRAN's dot in ``torch.matmul``'s order: the CPU route of
  ``simplex.lu`` and its bits.  A launch error raises; nothing falls back.

The kernels are compiled at first use, with the port's other kernels, by
``relp_tpu_torch.ops._build`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from relp_tpu_torch.ops import _build

# Threads of the kernels' one block (kThreads in the source): its dot sums
# each thread's elements t, t + THREADS, ... in order, then the 32 lanes of
# each warp and the 32 warps by halving trees.
THREADS = 1024
_WARP = 32

# Launches of each kernel since the last reset (one per call that reached
# the device); the plain versions do not count.
LAUNCHES: Dict[str, int] = {"ftran": 0, "btran": 0}

_ENTRIES = {
    ("ftran", torch.float32): "relp_eta_ftran_f32",
    ("ftran", torch.float64): "relp_eta_ftran_f64",
    ("btran", torch.float32): "relp_eta_btran_f32",
    ("btran", torch.float64): "relp_eta_btran_f64",
}
# {(kind, itemsize, card ordinal): the largest dynamic shared memory of a
# launch}, asked of each card once.
_MAX_SMEM: Dict[tuple, int] = {}
_LIB: Optional[ctypes.CDLL] = None


def _live(eta_count, steps: int, device) -> torch.Tensor:
    """(steps,) bool: slot k holds a live eta (k < eta_count)."""
    return torch.arange(steps, device=device) < eta_count


def eta_ftran_plain(eta_vals, eta_rows, eta_count, x, steps: Optional[int] = None):
    """x <- E_k^-1 ... E_1^-1 x over the first ``steps`` slots (all K by
    default); a slot past ``eta_count`` is skipped.  E = I + (w - e_r)
    e_r^T, so E^-1 x = x - (x_r / w_r)(w - e_r)."""
    steps = eta_vals.shape[0] if steps is None else steps
    if steps == 0:
        return x
    live = _live(eta_count, steps, x.device)
    rows = eta_rows.to(torch.int64)
    for k in range(steps):
        w, r1 = eta_vals[k], rows[k : k + 1]
        factor = x.index_select(0, r1) / w.index_select(0, r1)
        new = x - factor * w
        new.index_copy_(0, r1, factor)
        x = torch.where(live[k], new, x)
    return x


def block_dot(y, w):
    """y . w summed in the kernels' order: the products rounded, each of
    THREADS threads adding its elements t, t + THREADS, ... from 0 in
    order, each warp's 32 sums added by a halving tree (lane l and lane
    l + 16, then 8, 4, 2, 1), then the 32 warps' sums by the same tree.  A
    0-d tensor."""
    M = y.shape[0]
    rows = -(-M // THREADS)
    padded = torch.nn.functional.pad(y * w, (0, rows * THREADS - M)).reshape(rows, THREADS)
    # A sum that starts at +0 never becomes -0, so the padding's +0 terms,
    # which the kernel's threads do not add, change no bit.
    sums = torch.zeros(THREADS, dtype=padded.dtype, device=padded.device)
    for j in range(rows):
        sums = sums + padded[j]
    sums = sums.reshape(THREADS // _WARP, _WARP)
    half = _WARP // 2
    while half:
        sums = sums[:, :half] + sums[:, half : 2 * half]
        half //= 2
    sums = sums.reshape(THREADS // _WARP)
    half = sums.shape[0] // 2
    while half:
        sums = sums[:half] + sums[half : 2 * half]
        half //= 2
    return sums.reshape(())


def eta_btran_plain(eta_vals, eta_rows, eta_count, y, steps: Optional[int] = None,
                    order: str = "matmul"):
    """y <- y E_k^-1 ... E_1^-1 (row form), newest eta first, over the first
    ``steps`` slots (all K by default); only entry r moves: y'_r = y_r -
    (y.w - y_r) / w_r.  The dot is ``torch.matmul`` (``order="matmul"``)
    or ``block_dot``, the kernels' order (``order="kernel"``)."""
    if order not in ("matmul", "kernel"):
        raise ValueError(f"eta_btran_plain: unknown order {order!r}")
    dot = torch.matmul if order == "matmul" else block_dot
    steps = eta_vals.shape[0] if steps is None else steps
    if steps == 0:
        return y
    live = _live(eta_count, steps, y.device)
    rows = eta_rows.to(torch.int64)
    for k in reversed(range(steps)):
        w, r1 = eta_vals[k], rows[k : k + 1]
        y_r = y.index_select(0, r1)
        new_r = y_r - (dot(y, w) - y_r) / w.index_select(0, r1)
        y = y.index_copy(0, r1, torch.where(live[k], new_r, y_r))
    return y


def build() -> ctypes.CDLL:
    """The port's kernel library (built at first use), with this module's
    entry points declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.build()
    for name in _ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.relp_eta_ring_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.relp_eta_ring_smem_bytes.restype = ctypes.c_longlong
    lib.relp_eta_ring_max_smem.argtypes = [ctypes.c_int] * 2
    lib.relp_eta_ring_max_smem.restype = ctypes.c_longlong
    _LIB = lib
    return lib


def smem_bytes(kind: str, itemsize: int, K: int, M: int) -> int:
    """Dynamic shared memory of a launch that stages the vector, the rows
    and the pivots in shared memory (from the source)."""
    return build().relp_eta_ring_smem_bytes(itemsize, K, M, int(kind == "ftran"))


def fits_shared(kind: str, x: torch.Tensor, K: int) -> bool:
    """Whether the card's shared memory holds the pass's vector, rows and
    pivots; else the kernel keeps the vector in device memory."""
    key = (kind, x.element_size(), x.device.index)
    if key not in _MAX_SMEM:
        with torch.cuda.device(x.device):
            most = build().relp_eta_ring_max_smem(x.element_size(), int(kind == "ftran"))
        if most < 0:
            raise RuntimeError(f"eta_{kind}: shared memory query failed (error {-most})")
        _MAX_SMEM[key] = most
    return smem_bytes(kind, x.element_size(), K, x.shape[0]) <= _MAX_SMEM[key]


def _launch(kind, eta_vals, eta_rows, eta_count, x, shared: Optional[bool] = None):
    """One launch of the ``kind`` ("ftran" or "btran") kernel on CUDA
    tensors; ``shared`` forces the launch with the vector in shared memory
    (True) or in device memory (False), else ``fits_shared`` decides."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"eta_{kind}: unsupported dtype {x.dtype}")
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"eta_{kind}: the vector has shape {tuple(x.shape)}")
    K, M = eta_vals.shape[0], x.shape[0]
    for name, t, dtype, shape in (
        ("eta_vals", eta_vals, x.dtype, (K, M)),
        ("eta_rows", eta_rows, torch.int32, (K,)),
        ("eta_count", eta_count, torch.int32, ()),
    ):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"eta_{kind}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"eta_{kind}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t in (("eta_vals", eta_vals), ("eta_rows", eta_rows), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"eta_{kind}: {name} is not contiguous")
    lib = build()
    if shared is None:
        shared = fits_shared(kind, x, K)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if kind == "ftran" and not shared else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, _ENTRIES[kind, x.dtype])(
            eta_vals.data_ptr(), eta_rows.data_ptr(), eta_count.data_ptr(),
            x.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            K, M, int(shared), stream,
        )
    if rc != 0:
        raise RuntimeError(f"eta_{kind}: CUDA launch failed (error {rc}, K={K}, M={M}, "
                           f"shared={shared})")
    LAUNCHES[kind] += 1
    return out


def launches_kernel(x: torch.Tensor) -> bool:
    """Whether a pass over ``x`` launches the kernel (a CUDA tensor): it
    reads the live count on the device, so the caller sizes nothing on the
    host."""
    return x.device.type == "cuda"


def _route(kind, eta_vals, eta_rows, eta_count, x, steps):
    if launches_kernel(x):
        return _launch(kind, eta_vals, eta_rows, eta_count, x)
    if x.device.type != "cpu":
        raise ValueError(f"eta_{kind}: unsupported device {x.device}")
    if kind == "ftran":
        return eta_ftran_plain(eta_vals, eta_rows, eta_count, x, steps)
    return eta_btran_plain(eta_vals, eta_rows, eta_count, x, steps)


def eta_ftran(eta_vals, eta_rows, eta_count, x, steps: Optional[int] = None):
    """FTRAN through the live ring: one kernel launch on CUDA tensors (the
    bits of ``eta_ftran_plain``); on CPU tensors that plain loop over the
    first ``steps`` slots (all K by default), which must cover the live
    ones.  The kernel does not read ``steps``."""
    return _route("ftran", eta_vals, eta_rows, eta_count, x, steps)


def eta_btran(eta_vals, eta_rows, eta_count, y, steps: Optional[int] = None):
    """BTRAN through the live ring: one kernel launch on CUDA tensors (the
    bits of the ordered twin ``eta_btran_plain(..., order="kernel")``); on
    CPU tensors the plain loop in ``torch.matmul``'s order
    (``eta_btran_plain(..., steps)``, the CPU route's bits) over the first
    ``steps`` slots (all K by default), which must cover the live ones.
    The kernel does not read ``steps``."""
    return _route("btran", eta_vals, eta_rows, eta_count, y, steps)
