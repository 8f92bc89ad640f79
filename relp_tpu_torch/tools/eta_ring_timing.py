"""Times the eta-ring kernels (``ops.eta_ring``) on the card beside the
latency floor of their slot chain (``csrc/slot_chain.cu``), in one
process.

    python -m relp_tpu_torch.tools.eta_ring_timing [--rounds N]

On rings of K = 60 slots with 59 live (``testing.eta_ring_case``, seed 0)
at M = 384 and 1,920 (the main path's M), f32 and f64, each round times
with chip_smoke.py's CUDA-graph replay (``_graph_ms``), warm and L2-cold
(after a 128 MB read): both kernels with the vector in shared memory and
in device memory, in the order shared, device, device, shared; the slot
chain at 59 live slots and at none; both kernels at no live slot.  Every
launch is first held bitwise to its plain version.  Prints the card's
name and power limit, one line per case and round, and a JSON summary of
the means.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from relp_tpu_torch.ops import _build, eta_ring

_ROOT = Path(__file__).resolve().parents[2]
K, LIVE = 60, 59
SIZES = (384, 1920)
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build()
        lib.relp_slot_chain.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                                        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
        lib.relp_slot_chain.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def slot_chain(kind: str, eta_vals: torch.Tensor, eta_count: torch.Tensor) -> torch.Tensor:
    """One launch of the slot-chain probe of the ``kind`` ("ftran" or
    "btran") kernel over the ring's live slots; its (1024,) output is
    the last slot's reads (only so that nothing is optimised away)."""
    K_, M = eta_vals.shape
    out = torch.empty(eta_ring.THREADS, dtype=eta_vals.dtype, device=eta_vals.device)
    with torch.cuda.device(eta_vals.device):
        rc = _lib().relp_slot_chain(
            eta_vals.element_size(), int(kind == "btran"), eta_vals.data_ptr(),
            eta_count.data_ptr(), K_, M, out.data_ptr(),
            torch.cuda.current_stream(eta_vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slot_chain: launch failed (error {rc})")
    return out


def _plain(kind, inputs):
    if kind == "ftran":
        return eta_ring.eta_ftran_plain(*inputs)
    return eta_ring.eta_btran_plain(*inputs, order="kernel")


def _bits(a, b) -> bool:
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("needs a CUDA card")
    sys.path.insert(0, str(_ROOT))
    from chip_smoke import _flush, _graph_ms
    from relp_tpu_torch.testing import eta_ring_case

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda")
    flush = _flush(torch)
    summary = {"device": smi, "K": K, "live": LIVE, "cases": {}}
    for dtype in (np.float32, np.float64):
        for M in SIZES:
            inputs = tuple(torch.as_tensor(np.asarray(a), device=device)
                           for a in eta_ring_case(M, K, dtype, LIVE))
            vals, rows, count, x = inputs
            empty = torch.zeros_like(count)
            for kind in ("ftran", "btran"):
                want = _plain(kind, inputs)
                for shared in (True, False):
                    got = eta_ring._launch(kind, *inputs, shared=shared)
                    torch.cuda.synchronize()
                    if not _bits(got, want):
                        raise SystemExit(f"eta_{kind} shared={shared} M={M} {dtype}: "
                                         "differs from its plain version")
                rows_out = []
                for rnd in range(args.rounds):
                    row = {}
                    for where, fl in (("warm", None), ("cold", flush)):
                        turns = {True: [], False: []}
                        for shared in (True, False, False, True):
                            turns[shared].append(_graph_ms(
                                torch, lambda: eta_ring._launch(kind, *inputs, shared=shared),
                                flush=fl))
                        row[f"shared_{where}_ms"] = turns[True]
                        row[f"device_{where}_ms"] = turns[False]
                        row[f"chain_{where}_ms"] = _graph_ms(
                            torch, lambda: slot_chain(kind, vals, count), flush=fl)
                    row["chain_empty_ms"] = _graph_ms(
                        torch, lambda: slot_chain(kind, vals, empty))
                    row["kernel_empty_ms"] = _graph_ms(
                        torch, lambda: eta_ring._launch(kind, vals, rows, empty, x))
                    rows_out.append(row)
                    print(f"[eta_ring_timing] kind={kind} M={M} dtype={dtype.__name__} "
                          f"round={rnd} " + " ".join(f"{k}={v}" for k, v in row.items()),
                          flush=True)
                means = {}
                for key in rows_out[0]:
                    vals_ = [v for r in rows_out for v in
                             (r[key] if isinstance(r[key], list) else [r[key]])]
                    means[key] = sum(vals_) / len(vals_)
                    means[key + "_spread"] = max(vals_) - min(vals_)
                summary["cases"][f"{kind}/{M}/{dtype.__name__}"] = means
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
