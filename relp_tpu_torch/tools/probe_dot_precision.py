"""Precision probe of f32 products on the card: the port of
``scripts/probe_dot_precision.py``.

The JAX script asked whether a Pallas f32 dot on the TPU is single-pass
bf16 (relative error about 1e-3) or full f32 (about 1e-7), which decided
that the batched kernels carry their rank-1 updates on the vector units.
On Hopper the same question is about TF32: three hand-written kernels of
``csrc/probe_dot.cu`` compute one 256 x 256 f32 product of standard normal
matrices (seed 0) as

* ``tf32``: a single-pass TF32 product on the tensor cores (``mma.sync``),
  the counterpart of the default-precision dot;
* ``tf32x3``: three TF32 products of the split inputs, the counterpart of
  ``Precision.HIGHEST``;
* ``outer``: the outer product of the first column and the first row with
  plain f32 multiplies,

and the probe prints each one's largest error relative to the largest
entry of the product taken in f64 with numpy (the plain version).  On the
CPU the kernels' plain version stands in for them.

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
# Launches of each kernel since the last reset; the plain version does not
# count.
LAUNCHES: Dict[str, int] = {kind: 0 for kind in KINDS}
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build()
        lib.relp_probe_dot.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.relp_probe_dot.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def probe_dot_reference(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: the product in f64 with numpy (CPU tensor)."""
    a64 = a.detach().cpu().numpy().astype(np.float64)
    b64 = b.detach().cpu().numpy().astype(np.float64)
    out = np.outer(a64[:, 0], b64[0, :]) if kind == "outer" else a64 @ b64
    return torch.from_numpy(out)


def probe_dot(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``kind`` product of two (M, M) f32 matrices, M % 16 == 0, as an
    f32 matrix: the kernel on CUDA tensors, the plain version rounded to
    f32 on CPU tensors."""
    if kind not in KINDS:
        raise ValueError(f"probe_dot: kind {kind!r} is not one of {KINDS}")
    M = a.shape[0]
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or tuple(t.shape) != (M, M) or t.device != a.device:
            raise ValueError(f"probe_dot: {name} must be ({M}, {M}) float32 on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"probe_dot: {name} is not contiguous")
    if M < 16 or M % 16:
        raise ValueError(f"probe_dot: M={M} is not a positive multiple of 16")
    if a.device.type == "cpu":
        return probe_dot_reference(kind, a, b).to(torch.float32)
    if a.device.type != "cuda":
        raise ValueError(f"probe_dot: unsupported device {a.device}")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().relp_probe_dot(KINDS.index(kind), a.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), M, stream)
    if rc != 0:
        raise RuntimeError(f"probe_dot: CUDA launch failed (error {rc})")
    LAUNCHES[kind] += 1
    return out


def inputs(device, M: int = 256, seed: int = 0):
    """The probe's two standard normal (M, M) f32 matrices."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, M)).astype(np.float32)
    b = rng.standard_normal((M, M)).astype(np.float32)
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)


def relative_error(out: torch.Tensor, exact: torch.Tensor) -> float:
    """Largest error relative to the largest entry of the exact product."""
    diff = out.detach().cpu().double() - exact
    return float(diff.abs().max() / exact.abs().max())


def run(device, M: int = 256, seed: int = 0) -> Dict[str, float]:
    """Each kind's relative error on the probe's inputs."""
    a, b = inputs(device, M, seed)
    return {kind: relative_error(probe_dot(kind, a, b), probe_dot_reference(kind, a, b))
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
