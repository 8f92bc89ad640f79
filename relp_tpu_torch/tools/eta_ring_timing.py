"""Times the eta-ring kernels (``ops.eta_ring``) on the card beside the
latency floor of a slot chain that makes the whole vector wait on each
slot (``csrc/slot_chain.cu``) and, with ``--parent DIR``, beside an earlier
tree's kernels, in turns, in one process.

    python -m relp_tpu_torch.tools.eta_ring_timing [--parent DIR] [--rounds N]

DIR holds an unpacked earlier tree of the repository (for example
``git archive <commit> relp_tpu_torch | tar -x -C build/parent``).  Its
``relp_tpu_torch/csrc/eta_ring.cu`` is built alone with this tree's nvcc
flags into ``build/eta_parent/``, and its own ``ops/eta_ring.py`` (loaded
from DIR, its library swapped in) launches it.  On rings of K = 60 slots
with 59 live (``testing.eta_ring_case``, seed 0) at M = 384 and 1,920 (the
main path's M), f32 and f64, each round times with chip_smoke.py's
CUDA-graph replay (``_graph_ms``), warm and L2-cold (after a 128 MB read):
FTRAN; the BTRAN pair (59 and 58 live slots: an LU pivot's rho and
Goldfarb BTRANs) and one BTRAN; the parent's FTRAN and its two BTRANs for
the pair, in the order parent, change, change, parent; the slot chain at
59 live slots (the pair's: two BTRAN chains, 59 and 58 slots) and at none;
this tree's kernels at no live slot.  Every
launch is first held bitwise to its plain version (the parent's to its
own).  Prints the card's name and power limit, one line per case and
round, and a JSON summary of the means.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from relp_tpu_torch.ops import _build, eta_ring

_ROOT = Path(__file__).resolve().parents[2]
_PARENT_BUILD = _ROOT / "build" / "eta_parent"
K, LIVE = 60, 59
SIZES = (384, 1920)
# Threads of the slot-chain probe's one block (kThreads in its source).
CHAIN_THREADS = 1024
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
    """One launch of the slot-chain probe of a ``kind`` ("ftran" or
    "btran") pass over the ring's live slots; its (1024,) output is the
    last slot's reads (only so that nothing is optimised away)."""
    K_, M = eta_vals.shape
    out = torch.empty(CHAIN_THREADS, dtype=eta_vals.dtype, device=eta_vals.device)
    with torch.cuda.device(eta_vals.device):
        rc = _lib().relp_slot_chain(
            eta_vals.element_size(), int(kind == "btran"), eta_vals.data_ptr(),
            eta_count.data_ptr(), K_, M, out.data_ptr(),
            torch.cuda.current_stream(eta_vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slot_chain: launch failed (error {rc})")
    return out


def _parent_module(tree: Path):
    """DIR's ops/eta_ring.py as a module of its own, calling DIR's kernels
    built alone."""
    src = tree / "relp_tpu_torch" / "csrc" / "eta_ring.cu"
    _PARENT_BUILD.mkdir(parents=True, exist_ok=True)
    out = _PARENT_BUILD / "libeta_parent.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    spec = importlib.util.spec_from_file_location(
        "eta_parent", tree / "relp_tpu_torch" / "ops" / "eta_ring.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    lib = ctypes.CDLL(str(out))
    module._build = SimpleNamespace(build=lambda: lib)
    module._LIB = None
    return module


def _bits(a, b) -> bool:
    """Bitwise equal outputs (the pair's: both vectors)."""
    a, b = (torch.cat(t) if isinstance(t, tuple) else t for t in (a, b))
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _calls(module, inputs, w):
    """{kind: (call, plain)} of ``module``'s entries on one ring: FTRAN, one
    BTRAN, and the pair (x with the live count, w with one slot less; its
    two outputs); a module without the pair entry runs it as two BTRANs."""
    vals, rows, count, x = inputs
    count_b = count - 1
    pair = getattr(module, "eta_btran_pair", None)
    if pair is None:
        def pair(v, r, ca, ya, cb, yb):
            return module.eta_btran(v, r, ca, ya), module.eta_btran(v, r, cb, yb)

    def ordered(c, y):
        return module.eta_btran_plain(vals, rows, c, y, order="kernel")

    return {
        "ftran": (lambda: module.eta_ftran(*inputs),
                  lambda: module.eta_ftran_plain(*inputs)),
        "btran": (lambda: module.eta_btran(*inputs), lambda: ordered(count, x)),
        "pair": (lambda: pair(vals, rows, count, x, count_b, w),
                 lambda: (ordered(count, x), ordered(count_b, w))),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None)
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
    parent = _parent_module(args.parent) if args.parent else None
    summary = {"device": smi, "K": K, "live": LIVE, "parent": str(args.parent), "cases": {}}
    for dtype in (np.float32, np.float64):
        for M in SIZES:
            inputs = tuple(torch.as_tensor(np.asarray(a), device=device)
                           for a in eta_ring_case(M, K, dtype, LIVE))
            vals, rows, count, x = inputs
            w = torch.flip(x, (0,)).contiguous()
            empty = torch.zeros_like(count)
            change = _calls(eta_ring, inputs, w)
            before = _calls(parent, inputs, w) if parent is not None else {}
            idle = _calls(eta_ring, (vals, rows, empty, x), w)
            for kind in ("ftran", "btran", "pair"):
                for who, calls in (("change", change), ("parent", before)):
                    if kind in calls:
                        got, want = calls[kind][0](), calls[kind][1]()
                        torch.cuda.synchronize()
                        if not _bits(got, want):
                            raise SystemExit(f"{who} eta {kind} M={M} {dtype.__name__}: "
                                             "differs from its plain version")
                chain_kind = "ftran" if kind == "ftran" else "btran"
                # The pair's floor is two BTRAN chains: a pass that makes the
                # whole vector wait on each slot runs the two one after the other.
                counts = (count, count - 1) if kind == "pair" else (count,)

                def chain(counts=counts):
                    for c in counts:
                        slot_chain(chain_kind, vals, c)

                rows_out = []
                for rnd in range(args.rounds):
                    row = {}
                    for where, fl in (("warm", None), ("cold", flush)):
                        order = (("parent", "change", "change", "parent") if parent
                                 else ("change",))
                        for who in order:
                            calls = change if who == "change" else before
                            row.setdefault(f"{who}_{where}_ms", []).append(
                                _graph_ms(torch, calls[kind][0], flush=fl))
                        row[f"chain_{where}_ms"] = _graph_ms(torch, chain, flush=fl)
                    row["chain_empty_ms"] = _graph_ms(
                        torch, lambda: slot_chain(chain_kind, vals, empty))
                    row["change_empty_ms"] = _graph_ms(torch, idle[kind][0])
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
