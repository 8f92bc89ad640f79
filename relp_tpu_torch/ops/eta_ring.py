"""The LU engine's eta ring, FTRAN and BTRAN: the hand-written CUDA kernels
(one launch a pass, BTRAN of one vector or of two at once) and their plain
PyTorch versions.

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
  summation order the library chooses) or the kernel's order
  (``order="kernel"``, the ordered twin, below).
* ``eta_ftran`` / ``eta_btran`` / ``eta_btran_pair``: on CUDA tensors
  (``launches_kernel``) one launch of ``csrc/eta_ring.cu``, which reads the
  live counts on the device, so the pass has no host read and no length
  set on the host; FTRAN gives the bits of ``eta_ftran_plain``, BTRAN those
  of ``eta_btran_plain(..., order="kernel")``, and the pair (two vectors
  through one ring, each with its own count: the LU pivot's rho and
  Goldfarb BTRANs) those of two such calls.  On CPU tensors the plain
  loops run over ``steps`` slots, BTRAN's dot in ``torch.matmul``'s order:
  the CPU route of ``simplex.lu`` and its bits.  A launch error raises;
  nothing falls back.

The kernel's BTRAN order.  With R the rows of the live slots, slot k's dot
is S_k, the products y0_i w_k[i] over the elements outside R (an element
in R enters with y = 0) in tiles of TILE = 256 elements (lane l adds elements l,
l + 32, ..., from +0; the 32 lanes by a halving tree, lane l and lane
l + 16, then 8, 4, 2, 1; the tiles in order from tile 0); then y0[r_j]
w_k[r_j] for j = 0 .. k in order over the slots that are the last live
slot on their row; then, newest slot first, y_new_j w_k[r_j] for each
slot j > k with no live slot on its row between k and j.  Every product,
sum and difference rounded on its own.

The kernels are compiled at first use, with the port's other kernels, by
``relp_tpu_torch.ops._build`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from relp_tpu_torch.ops import _build

# Slots of one chain group of the kernels (kGroup in the source): past it
# the chain reads the ring from L2.
CHAIN_SLOTS = 64
# BTRAN's tiles (kTileRows, kTile): each lane adds TILE_ROWS elements.
TILE_ROWS = 8
TILE = 32 * TILE_ROWS

# Launches of each kernel since the last reset (one per call that reached
# the device): "btran" counts the BTRAN launches of one vector,
# "btran_pair" those of two.  The plain versions do not count.
LAUNCHES: Dict[str, int] = {"ftran": 0, "btran": 0, "btran_pair": 0}

_ENTRIES = {
    ("ftran", torch.float32): "relp_eta_ftran_f32",
    ("ftran", torch.float64): "relp_eta_ftran_f64",
    ("btran", torch.float32): "relp_eta_btran_f32",
    ("btran", torch.float64): "relp_eta_btran_f64",
}
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


def _tile_sums(prods):
    """(S, M) products -> (S,) sums in the kernel's order: tiles of TILE
    elements, lane l adding elements l, l + 32, ... from +0, the lanes by a
    halving tree, the tiles in order."""
    S, M = prods.shape
    tiles = -(-M // TILE)
    # A sum that starts at +0 never becomes -0, so the padding's +0 terms,
    # which the kernel's lanes do not add, change no bit (nor does the
    # signed zero of a live row's product).
    p = torch.nn.functional.pad(prods, (0, tiles * TILE - M)).reshape(S, tiles, TILE_ROWS, 32)
    lanes = torch.zeros((S, tiles, 32), dtype=prods.dtype, device=prods.device)
    for m in range(TILE_ROWS):
        lanes = lanes + p[:, :, m]
    half = 16
    while half:
        lanes = lanes[..., :half] + lanes[..., half : 2 * half]
        half //= 2
    sums = lanes[..., 0]
    total = sums[:, 0]
    for t in range(1, tiles):
        total = total + sums[:, t]
    return total


def _btran_kernel_order(eta_vals, eta_rows, eta_count, y, steps: int):
    """BTRAN with the kernel's dot order (the module's docstring), over the
    first ``steps`` slots, each masked by ``k < eta_count``."""
    live = _live(eta_count, steps, y.device)
    rows = eta_rows[:steps].to(torch.int64)
    idx = torch.arange(steps, device=y.device)
    same = rows[:, None] == rows[None, :]
    # last[j]: no later live slot on r_j; prev[j]: the earlier slot on r_j.
    last = ~(same & (idx[None, :] > idx[:, None]) & live[None, :]).any(1)
    prev = torch.where(same & (idx[None, :] < idx[:, None]), idx[None, :], -1).max(1).values
    in_R = torch.zeros(y.shape[0], dtype=torch.int32, device=y.device).index_add_(
        0, rows, live.to(torch.int32)) > 0
    W = eta_vals[:steps]
    S = _tile_sums(torch.where(in_R, 0.0, y) * W)
    G = W.index_select(1, rows)
    y0r = y.index_select(0, rows)
    A = S
    for j in range(steps):
        A = torch.where(live[j] & last[j] & (idx >= j), A + y0r[j] * G[:, j], A)
    for j in reversed(range(steps)):
        r1 = rows[j : j + 1]
        y_r = y.index_select(0, r1)
        new_r = y_r - (A[j] - y_r) / G[j, j]
        A = torch.where(live[j] & (idx < j) & (prev[j] <= idx), A + new_r * G[:, j], A)
        y = y.index_copy(0, r1, torch.where(live[j], new_r, y_r))
    return y


def eta_btran_plain(eta_vals, eta_rows, eta_count, y, steps: Optional[int] = None,
                    order: str = "matmul"):
    """y <- y E_k^-1 ... E_1^-1 (row form), newest eta first, over the first
    ``steps`` slots (all K by default); only entry r moves: y'_r = y_r -
    (y.w - y_r) / w_r.  The dot is ``torch.matmul`` (``order="matmul"``)
    or summed in the kernel's order (``order="kernel"``: the ordered twin,
    whose bits the kernel gives)."""
    if order not in ("matmul", "kernel"):
        raise ValueError(f"eta_btran_plain: unknown order {order!r}")
    steps = eta_vals.shape[0] if steps is None else steps
    if steps == 0:
        return y
    if order == "kernel":
        return _btran_kernel_order(eta_vals, eta_rows, eta_count, y, steps)
    live = _live(eta_count, steps, y.device)
    rows = eta_rows.to(torch.int64)
    for k in reversed(range(steps)):
        w, r1 = eta_vals[k], rows[k : k + 1]
        y_r = y.index_select(0, r1)
        new_r = y_r - (torch.matmul(y, w) - y_r) / w.index_select(0, r1)
        y = y.index_copy(0, r1, torch.where(live[k], new_r, y_r))
    return y


def eta_btran_pair_plain(eta_vals, eta_rows, count_a, y_a, count_b, y_b,
                         steps_a: Optional[int] = None, steps_b: Optional[int] = None,
                         order: str = "matmul"):
    """Two BTRANs through one ring, each with its own live count: two calls
    of ``eta_btran_plain``."""
    return (eta_btran_plain(eta_vals, eta_rows, count_a, y_a, steps_a, order),
            eta_btran_plain(eta_vals, eta_rows, count_b, y_b, steps_b, order))


def build() -> ctypes.CDLL:
    """The port's kernel library (built at first use), with this module's
    entry points declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.build()
    for (kind, _dtype), name in _ENTRIES.items():
        fn = getattr(lib, name)
        if kind == "ftran":
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        else:
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 7
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def _check(kind, eta_vals, eta_rows, eta_count, x):
    """Refuse what the kernels do not take (before anything is built)."""
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


def _launch(kind, eta_vals, eta_rows, passes):
    """One launch of the ``kind`` ("ftran" or "btran") kernel on CUDA
    tensors; ``passes`` holds (eta_count, vector) pairs, one for FTRAN, one
    or two for BTRAN, each vector through the same ring with its own live
    count.  Returns a tuple of the outputs."""
    if not 1 <= len(passes) <= (1 if kind == "ftran" else 2):
        raise ValueError(f"eta_{kind}: {len(passes)} vectors in one launch")
    for count, x in passes:
        _check(kind, eta_vals, eta_rows, count, x)
    x0 = passes[0][1]  # each vector is eta_vals' dtype and device, so all alike
    K, M = eta_vals.shape[0], x0.shape[0]
    lib = build()
    outs = tuple(torch.empty_like(x) for _c, x in passes)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        entry = getattr(lib, _ENTRIES[kind, x0.dtype])
        if kind == "ftran":
            (count, x), = passes
            rc = entry(eta_vals.data_ptr(), eta_rows.data_ptr(), count.data_ptr(),
                       x.data_ptr(), outs[0].data_ptr(), K, M, stream)
        else:
            # Each tile's sums, one a live slot and vector, read back by
            # the kernel's block 0.
            part = torch.empty(-(-M // TILE) * len(passes) * K, dtype=x0.dtype,
                               device=x0.device)
            b = passes[1] if len(passes) == 2 else (None, None)
            rc = entry(eta_vals.data_ptr(), eta_rows.data_ptr(), len(passes),
                       passes[0][0].data_ptr(), passes[0][1].data_ptr(), outs[0].data_ptr(),
                       b[0].data_ptr() if b[0] is not None else None,
                       b[1].data_ptr() if b[1] is not None else None,
                       outs[1].data_ptr() if len(outs) == 2 else None,
                       part.data_ptr(), K, M, stream)
    if rc != 0:
        raise RuntimeError(f"eta_{kind}: CUDA launch failed (error {rc}, K={K}, M={M}, "
                           f"vectors={len(passes)})")
    LAUNCHES["btran_pair" if len(passes) == 2 else kind] += 1
    return outs


def launches_kernel(x: torch.Tensor) -> bool:
    """Whether a pass over ``x`` launches the kernel (a CUDA tensor): it
    reads the live count on the device, so the caller sizes nothing on the
    host."""
    return x.device.type == "cuda"


def _require_cpu(kind, x):
    if x.device.type != "cpu":
        raise ValueError(f"eta_{kind}: unsupported device {x.device}")


def eta_ftran(eta_vals, eta_rows, eta_count, x, steps: Optional[int] = None):
    """FTRAN through the live ring: one kernel launch on CUDA tensors (the
    bits of ``eta_ftran_plain``); on CPU tensors that plain loop over the
    first ``steps`` slots (all K by default), which must cover the live
    ones.  The kernel does not read ``steps``."""
    if launches_kernel(x):
        return _launch("ftran", eta_vals, eta_rows, ((eta_count, x),))[0]
    _require_cpu("ftran", x)
    return eta_ftran_plain(eta_vals, eta_rows, eta_count, x, steps)


def eta_btran(eta_vals, eta_rows, eta_count, y, steps: Optional[int] = None):
    """BTRAN through the live ring: one kernel launch on CUDA tensors (the
    bits of the ordered twin ``eta_btran_plain(..., order="kernel")``); on
    CPU tensors the plain loop in ``torch.matmul``'s order
    (``eta_btran_plain(..., steps)``, the CPU route's bits) over the first
    ``steps`` slots (all K by default), which must cover the live ones.
    The kernel does not read ``steps``."""
    if launches_kernel(y):
        return _launch("btran", eta_vals, eta_rows, ((eta_count, y),))[0]
    _require_cpu("btran", y)
    return eta_btran_plain(eta_vals, eta_rows, eta_count, y, steps)


def eta_btran_pair(eta_vals, eta_rows, count_a, y_a, count_b, y_b,
                   steps_a: Optional[int] = None, steps_b: Optional[int] = None):
    """Two BTRANs through the same ring, each with its own live count: one
    kernel launch on CUDA tensors, which reads the ring once (the bits of
    two calls of the ordered twin); on CPU tensors two plain loops in
    ``torch.matmul``'s order over ``steps_a`` and ``steps_b`` slots
    (``eta_btran_pair_plain``, the CPU route's bits)."""
    if launches_kernel(y_a):
        return _launch("btran", eta_vals, eta_rows, ((count_a, y_a), (count_b, y_b)))
    _require_cpu("btran", y_a)
    return eta_btran_pair_plain(eta_vals, eta_rows, count_a, y_a, count_b, y_b,
                                steps_a, steps_b)
