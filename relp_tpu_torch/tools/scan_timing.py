"""Times the fused price scan on the card against an earlier tree's kernel
and across launch tilings, in turns, in one process.

    python -m relp_tpu_torch.tools.scan_timing [--parent DIR] [--sweep] [--rounds N]

DIR holds an unpacked earlier tree of the repository (for example
``git archive <commit> relp_tpu_torch | tar -x -C build/parent``).  Its
``relp_tpu_torch/csrc/price_scan.cu`` is built alone with this tree's nvcc
flags into ``build/scan_parent/``, and its own ``ops/price_scan.py`` (loaded
from DIR, its library swapped in) launches it, so the parent's launch
choices are its own.  At each shape and dtype of chip_smoke.py's kernel phase
(``scan_cases``), on the same inputs, every round times with chip_smoke.py's
CUDA-graph replay (``_graph_ms``), warm and after an L2 flush, the parent's
kernel and this tree's in the order parent, change, change, parent, and
``torch.matmul(P, A)``.  With ``--sweep`` it also times this tree's kernel
under each tiling of ``candidates`` (tile bytes, cluster) and
marks the one ``price_scan.tiling`` picks.  Prints the card's name and power
limit, one line per case (and tiling), and a JSON summary.  Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from relp_tpu_torch.ops import _build, price_scan

_ROOT = Path(__file__).resolve().parents[2]
_PARENT_BUILD = _ROOT / "build" / "scan_parent"


def _parent_module(tree: Path):
    """DIR's ops/price_scan.py as a module of its own, calling DIR's kernel
    built alone."""
    src = tree / "relp_tpu_torch" / "csrc" / "price_scan.cu"
    _PARENT_BUILD.mkdir(parents=True, exist_ok=True)
    out = _PARENT_BUILD / "libscan_parent.so"
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    spec = importlib.util.spec_from_file_location(
        "scan_parent", tree / "relp_tpu_torch" / "ops" / "price_scan.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    import ctypes

    lib = ctypes.CDLL(str(out))
    module._build = SimpleNamespace(build=lambda: lib)
    module._LIB = None
    return module


def candidates(M: int, N: int, itemsize: int):
    """The tilings the sweep times: tiles of 128 B, 256 B and 512 B, clusters
    of 1-8 ranks (none that would leave a rank without rows)."""
    out = []
    for tile_bytes in (128, 256, 512):
        for cluster in (1, 2, 4, 8):
            rows = -(-M // cluster)
            if cluster == 1 or (cluster - 1) * rows < M:
                out.append(price_scan.Tiling(tile_bytes // itemsize, cluster, rows))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("needs a CUDA card")
    sys.path.insert(0, str(_ROOT))
    from chip_smoke import _graph_ms, _scan_inputs, main_path_shape, scan_cases

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda")
    parent = _parent_module(args.parent) if args.parent else None
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=device)
    summary = []
    for M, N, name in scan_cases(main_path_shape()):
        dtype = getattr(torch, name)
        P, A, c, g, gq = _scan_inputs(torch, np, device, M, N, dtype)
        calls = {"change": lambda: price_scan.fused_price_scan(P, A, c, g, gq),
                 "matmul": lambda: torch.matmul(P, A)}
        if parent is not None:
            calls["parent"] = lambda: parent.fused_price_scan(P, A, c, g, gq)
            d0, g0 = parent.fused_price_scan(P, A, c, g, gq)
            d1, g1 = price_scan.fused_price_scan(P, A, c, g, gq)
            torch.cuda.synchronize()
            agree = max(float((d0.double() - d1.double()).abs().max()),
                        float((g0.double() - g1.double()).abs().max()))
        order = ["parent", "change", "change", "parent"] if parent else ["change"]
        times = {}
        for _round in range(args.rounds):
            for who in order + ["matmul"]:
                for cold in (False, True):
                    ms = _graph_ms(torch, calls[who], flush=flush if cold else None)
                    times.setdefault((who, cold), []).append(ms)
        mean = {f"{who}{'_cold' if cold else ''}_ms": float(np.mean(v))
                for (who, cold), v in times.items()}
        row = dict(shape=f"{M}x{N}", dtype=str(dtype).replace("torch.", ""),
                   tiling=list(price_scan.tiling(M, N, A.element_size())), **mean)
        if parent is not None:
            row["parent_vs_change_abs"] = agree
        print("[scan_timing] " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        summary.append(row)
        if args.sweep:
            chosen = price_scan.tiling(M, N, A.element_size())
            for t in candidates(M, N, A.element_size()):
                def call(t=t):
                    return price_scan._launch(P, A, c, g, gq, t)

                warm = _graph_ms(torch, call)
                cold = _graph_ms(torch, call, flush=flush)
                print(f"[scan_sweep] shape={M}x{N} dtype={row['dtype']} "
                      f"tile_bytes={t.tile_cols * A.element_size()} cluster={t.cluster} "
                      f"ms={warm:.5f} cold_ms={cold:.5f}"
                      f"{' chosen' if t == chosen else ''}", flush=True)
    print(json.dumps({"device": smi, "scan_timing": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
