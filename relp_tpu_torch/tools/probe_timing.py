"""Times the precision probe's kernels on the card against an earlier
tree's kernels, in turns, in one process.

    python -m relp_tpu_torch.tools.probe_timing [--parent DIR] [--rounds N]

DIR holds an unpacked earlier tree of the repository (for example
``git archive <commit> relp_tpu_torch/csrc | tar -x -C build/parent``).
Its ``relp_tpu_torch/csrc/probe_dot.cu`` is built alone with this tree's
nvcc flags into ``build/probe_parent/`` and called through the same C
entry, ``relp_probe_dot(kind, A, B, C, M, stream)``, on the same inputs.
For each of ``tf32`` and ``tf32x3`` at M=256 every round times, with
chip_smoke.py's CUDA-graph replay (``_graph_ms``), the parent's kernel
and this tree's in the order parent, change, change, parent, then this
tree's kernel with each K split (4, 2, 1 CTAs a tile), ``torch.matmul``
(TF32 allowed for tf32, full f32 for tf32x3) and the empty kernel of this
tree's source (the floor). For ``outer`` at M = 256, 1,920 and 4,096
every round times, warm and L2-cold (each call after a 128 MB read,
chip_smoke.py's ``_flush``), the parent's kernel and this tree's in the
same turns, ``torch.outer``, and ``fill_`` of an (M, M) f32 tensor
(torch's write of C's bytes alone: the write rate the card reaches,
beside the bound's 3.35 TB/s); this tree's kernel is first held bitwise
to the plain version, the parent's to this tree's. Prints the card's name
and power limit, one line per kind (shape) and round, and a JSON summary
of the means. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from relp_tpu_torch.ops import _build
from relp_tpu_torch.tools import probe_dot_precision as probe

_ROOT = Path(__file__).resolve().parents[2]
_PARENT_BUILD = _ROOT / "build" / "probe_parent"
SPLITS = (4, 2, 1)
OUTER_SIZES = (256, 1920, 4096)


def _parent_lib(tree: Path) -> ctypes.CDLL:
    src = tree / "relp_tpu_torch" / "csrc" / "probe_dot.cu"
    _PARENT_BUILD.mkdir(parents=True, exist_ok=True)
    out = _PARENT_BUILD / "libprobe_parent.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.relp_probe_dot.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.relp_probe_dot.restype = ctypes.c_int
    return lib


def _means(rows):
    means = {}
    for key in rows[0]:
        vals = [v for row in rows for v in
                (row[key] if isinstance(row[key], list) else [row[key]])]
        means[key] = sum(vals) / len(vals)
    return means


def _in_turns(graph_ms, parent_fn, change_fn, **kw):
    """(parent ms, change ms) in the order parent, change, change, parent."""
    turns = [(who, graph_ms(parent_fn if who == "parent" else change_fn, **kw))
             for who in ("parent", "change", "change", "parent")]
    return ([ms for who, ms in turns if who == "parent"],
            [ms for who, ms in turns if who == "change"])


def _time_outer(graph_ms, flush, device, parent_call, rounds, floor_ms):
    """Per M of OUTER_SIZES: the rounds' rows and their means."""
    from chip_smoke import F32_FLOPS, _bound

    out = {}
    for M in OUTER_SIZES:
        a, b = probe.inputs(device, M)
        plain = probe.probe_dot_reference("outer", a, b).to(torch.float32)
        if not torch.equal(probe.probe_dot("outer", a, b), plain):
            raise AssertionError(f"outer at M={M}: not the plain version's bits")
        if parent_call is not None and not torch.equal(parent_call("outer", a, b),
                                                       probe.probe_dot("outer", a, b)):
            raise AssertionError(f"outer at M={M}: the parent's bits differ")
        bound_ms, bound_by = _bound((2 * M + M * M) * 4, 1.0 * M * M, F32_FLOPS)
        filled = torch.empty_like(a)
        rows = []
        for rnd in range(rounds):
            row = {}
            for state, kw in (("warm", {}), ("cold", {"flush": flush})):
                if parent_call is not None:
                    row[f"parent_{state}_ms"], row[f"change_{state}_ms"] = _in_turns(
                        graph_ms, lambda: parent_call("outer", a, b),
                        lambda: probe.probe_dot("outer", a, b), **kw)
                else:
                    row[f"change_{state}_ms"] = graph_ms(
                        lambda: probe.probe_dot("outer", a, b), **kw)
                row[f"torch_outer_{state}_ms"] = graph_ms(
                    lambda: torch.outer(a[:, 0], b[0, :]), **kw)
                row[f"fill_{state}_ms"] = graph_ms(lambda: filled.fill_(1.0), **kw)
            rows.append(row)
            print(f"[timing] kind=outer M={M} round={rnd} bound_ms={bound_ms:.5f} "
                  f"floor_ms={floor_ms:.5f} "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        out[M] = dict(_means(rows), bound_ms=bound_ms, bound_by=bound_by, floor_ms=floor_ms)
        del a, b, plain, filled
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("needs a CUDA card")
    sys.path.insert(0, str(_ROOT))
    from chip_smoke import _flush, _graph_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda")
    parent = _parent_lib(args.parent) if args.parent else None

    def graph_ms(fn, **kw):
        return _graph_ms(torch, fn, **kw)

    a, b = probe.inputs(device)
    M = a.shape[0]

    def parent_call(kind, a=a, b=b):
        out = torch.empty_like(a)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = parent.relp_probe_dot(probe.KINDS.index(kind), a.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), a.shape[0], stream)
        if rc != 0:
            raise RuntimeError(f"parent probe_dot failed (error {rc})")
        return out

    summary = {"device": smi, "M": M, "kinds": {}}
    for kind in ("tf32", "tf32x3"):
        if parent is not None:  # how far apart the two trees' products are
            parent_out, change_out = parent_call(kind), probe.probe_dot(kind, a, b)
            torch.cuda.synchronize()
            print(f"[timing] kind={kind} parent_vs_change_max_abs="
                  f"{float((parent_out - change_out).abs().max()):.3e}", flush=True)
        rows = []
        for rnd in range(args.rounds):
            row = {}
            if parent is not None:
                row["parent_ms"], row["change_ms"] = _in_turns(
                    graph_ms, lambda: parent_call(kind), lambda: probe.probe_dot(kind, a, b))
            for split in SPLITS:
                row[f"split{split}_ms"] = graph_ms(
                    lambda: probe.probe_dot(kind, a, b, split=split))
            torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
            try:
                row["matmul_ms"] = graph_ms(lambda: torch.matmul(a, b))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            row["floor_ms"] = graph_ms(lambda: probe.empty_launch(device))
            rows.append(row)
            print(f"[timing] kind={kind} M={M} round={rnd} "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        summary["kinds"][kind] = _means(rows)
    floor_ms = _graph_ms(torch, lambda: probe.empty_launch(device))
    summary["kinds"]["outer"] = _time_outer(
        graph_ms, _flush(torch), device, parent_call if parent is not None else None,
        args.rounds, floor_ms)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
