"""Precision probe of f32 products on the card: the port of
``scripts/probe_dot_precision.py``.

The JAX script asked whether a Pallas f32 dot on the TPU is single-pass
bf16 (relative error about 1e-3) or full f32 (about 1e-7), which decided
that the batched kernels carry their rank-1 updates on the vector units.
On Hopper the same question is about TF32: three hand-written kernels of
``csrc/probe_dot.cu`` compute one 256 x 256 f32 product of standard normal
matrices (seed 0) as

* ``tf32``: a single-pass TF32 product on the tensor cores (``wgmma``),
  the counterpart of the default-precision dot;
* ``tf32x3``: three TF32 products of the split inputs, the counterpart of
  ``Precision.HIGHEST``;
* ``outer``: the outer product of the first column and the first row with
  plain f32 multiplies, subnormals flushed as XLA's CPU multiply flushes
  them (``outer_reference``),

and the probe prints each one's largest error relative to the largest
entry of the exact product (``exact_product``: f64 with numpy on the
host).  ``probe_dot_reference`` is the kernels' plain version: plain torch
on the inputs' own device computing what each kernel computes (TF32
rounding included), so the kernels are held to it up to f32 summation
order.  On the CPU the plain version stands in for the kernels, so
``--platform cpu`` prints the TF32 rounding's error too (about 3e-4).
The matrices are square, (M, M) with M a positive multiple of 64.

    python -m relp_tpu_torch.tools.probe_dot_precision [--platform cpu]
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from relp_tpu_torch.ops import _build

KINDS = ("tf32", "tf32x3", "outer")
# The kernels take (M, M) matrices with M a positive multiple of this: one
# 64 x 64 output tile per warpgroup, K read in 64-wide slices.
TILE = 64
# The smallest normal f32.
FLT_MIN = 2.0 ** -126
# Launches of each kernel since the last reset; the plain version does not
# count.
LAUNCHES: Dict[str, int] = {kind: 0 for kind in KINDS}
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build()
        lib.relp_probe_dot_split.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.relp_probe_dot_split.restype = ctypes.c_int
        lib.relp_probe_empty.argtypes = [ctypes.c_void_p]
        lib.relp_probe_empty.restype = ctypes.c_int
        lib.relp_probe_smem_bytes.argtypes = [ctypes.c_int]
        lib.relp_probe_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on a finite f32 tensor: round to nearest, ties
    away from zero, keeping 10 mantissa bits (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    """(hi, lo) of the 3xTF32 product: hi = round_tf32(x), lo =
    round_tf32(x - hi) with the subtraction in f32."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def _flush_inputs(x: torch.Tensor) -> torch.Tensor:
    """Subnormal values read as zero, signs kept."""
    return torch.where(x.abs() < FLT_MIN, x * 0, x)


def outer_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 products a[i, 0] * b[0, j] as XLA's f32 multiply on the CPU
    (where the JAX probe's ``kernel_outer`` runs) computes them: subnormal
    inputs read as zero, and a product below 2^-126 after rounding with an
    unbounded exponent, that is one whose exact value is below 2^-126 -
    2^-151, becomes zero; signs kept."""
    col, row = _flush_inputs(a[:, :1]), _flush_inputs(b[:1, :])
    out = col * row
    tiny = (col.double() * row.double()).abs() < FLT_MIN - 2.0 ** -151  # exact in f64
    return torch.where(tiny, out * 0, out)


def probe_dot_reference(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version, on the inputs' device, as an f64 matrix: what the
    ``kind`` kernel computes, summed exactly (f64) where the kernel sums in
    f32.  ``tf32``: round_tf32(a) @ round_tf32(b); ``tf32x3``: lo_a hi_b +
    hi_a lo_b + hi_a hi_b of the split inputs (lo lo dropped, as the kernel
    drops it); ``outer``: ``outer_reference``, bit for bit."""
    if kind == "outer":
        return outer_reference(a, b).double()
    if kind == "tf32":
        return round_tf32(a).double() @ round_tf32(b).double()
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    a_hi, a_lo, b_hi, b_lo = (t.double() for t in (a_hi, a_lo, b_hi, b_lo))
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def exact_product(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact product of the f32 inputs, in f64 with numpy (a CPU
    tensor): the yardstick of each kind's error."""
    a64 = a.detach().cpu().numpy().astype(np.float64)
    b64 = b.detach().cpu().numpy().astype(np.float64)
    out = np.outer(a64[:, 0], b64[0, :]) if kind == "outer" else a64 @ b64
    return torch.from_numpy(out)


def _check(kind: str, a: torch.Tensor, b: torch.Tensor) -> int:
    if kind not in KINDS:
        raise ValueError(f"probe_dot: kind {kind!r} is not one of {KINDS}")
    M = a.shape[0] if a.dim() else 0
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or tuple(t.shape) != (M, M) or t.device != a.device:
            raise ValueError(f"probe_dot: {name} must be ({M}, {M}) float32 on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"probe_dot: {name} is not contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"probe_dot: {name} is not 16-byte aligned")
    if M < TILE or M % TILE:
        raise ValueError(f"probe_dot: M={M} is not a positive multiple of {TILE}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"probe_dot: unsupported device {a.device}")
    return M


def probe_dot(kind: str, a: torch.Tensor, b: torch.Tensor, split: int = 0) -> torch.Tensor:
    """The ``kind`` product of two (M, M) f32 matrices, M a positive
    multiple of 64, as an f32 matrix: the kernel on CUDA tensors, the
    plain version rounded to f32 on CPU tensors.  ``split`` (CUDA only,
    for timing another tiling) is the number of K-slices of each output
    tile, one CTA each in a cluster (1, 2 or 4; 0: the kernel's default,
    the largest that divides M / 64)."""
    M = _check(kind, a, b)
    if a.device.type == "cpu":
        return probe_dot_reference(kind, a, b).to(torch.float32)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().relp_probe_dot_split(KINDS.index(kind), a.data_ptr(), b.data_ptr(),
                                         out.data_ptr(), M, split, stream)
    if rc != 0:
        raise RuntimeError(f"probe_dot: CUDA launch failed (error {rc})")
    LAUNCHES[kind] += 1
    return out


def empty_launch(device) -> None:
    """One launch of the empty kernel of ``csrc/probe_dot.cu`` (one block):
    the floor under any kernel's time on the card.  Not counted."""
    with torch.cuda.device(device):
        rc = _lib().relp_probe_empty(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_dot: empty kernel launch failed (error {rc})")


def smem_bytes(kind: str) -> int:
    """Dynamic shared memory per CTA of the ``tf32`` or ``tf32x3`` kernel."""
    return _lib().relp_probe_smem_bytes(KINDS.index(kind))


def inputs(device, M: int = 256, seed: int = 0):
    """The probe's two standard normal (M, M) f32 matrices."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, M)).astype(np.float32)
    b = rng.standard_normal((M, M)).astype(np.float32)
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)


# f32 bit patterns that the outer product's edge case puts at the head of
# A[:, 0] and of B[0, :], so that every pair of them is multiplied: signed
# zeros, subnormals, the smallest normals, infinities, NaNs, the largest
# finite value, factors whose products are subnormal (2^-64 2^-63) or
# overflow (2^64 2^64), and 1.5 2^-126 and 2^-126 (1 + 2^-23) beside 2/3
# rounded down (0x3F2AAAAA) and 1 - 2^-23: the products 2^-126 - 2^-150
# (flushed) and 2^-126 - 2^-172 (rounded up to 2^-126), one on each side
# of the 2^-126 - 2^-151 that decides.
EDGE_BITS = (
    0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x00400000, 0x007FFFFF, 0x807FFFFF,
    0x00800000, 0x80800000, 0x00800001, 0x00C00000, 0x7F800000, 0xFF800000, 0x7FC00000,
    0xFFC00001, 0x7F7FFFFF, 0x1F800000, 0x20000000, 0x5F800000, 0x3F2AAAAA, 0x3F7FFFFE,
    0x3F800000, 0xBF800000,
)


def edge_inputs(device, M: int = 64, seed: int = 0):
    """The probe's inputs with ``EDGE_BITS`` at the head of A[:, 0] and of
    B[0, :]."""
    a, b = inputs("cpu", M, seed)
    edge = torch.tensor(np.array(EDGE_BITS, dtype=np.uint32).view(np.int32)).view(torch.float32)
    a[: len(edge), 0] = edge
    b[0, : len(edge)] = edge
    return a.to(device), b.to(device)


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether two f32 tensors hold the same bits, NaN compared by position
    (its payload and sign aside)."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]))


def relative_error(out: torch.Tensor, exact: torch.Tensor) -> float:
    """Largest error relative to the largest entry of the exact product."""
    diff = out.detach().cpu().double() - exact.cpu()
    return float(diff.abs().max() / exact.abs().max())


def run(device, M: int = 256, seed: int = 0) -> Dict[str, float]:
    """Each kind's relative error against the exact product on the probe's
    inputs."""
    a, b = inputs(device, M, seed)
    return {kind: relative_error(probe_dot(kind, a, b), exact_product(kind, a, b))
            for kind in KINDS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card: pass --platform cpu for the plain version")
    for kind, err in run(torch.device(args.platform)).items():
        print(f"{kind:8s} max rel err = {err:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
