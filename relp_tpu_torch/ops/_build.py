"""One build of every CUDA source of the port.

Every ``relp_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one process per source, all started together, and linked
into one shared library under ``build/relp_tpu_torch/`` of the checkout,
named by the hash of all sources: an unchanged checkout loads the cached
library, and any edit rebuilds it.  The library has a plain C interface and
is loaded with ``ctypes``; each kernel module declares its own entry points.
Nothing is compiled before a kernel is first called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "relp_tpu_torch"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# nvcc's output of the build that produced the loaded library (ptxas
# registers, shared memory and spills per kernel), and the seconds that
# build took (0.0 when a cached library was loaded).
BUILD_LOG = ""
BUILD_SECONDS = 0.0
_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in cmds
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
            )
    return outputs


def build() -> ctypes.CDLL:
    """Compile (once per content of all sources) and load the library."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    srcs = sources()
    digest = hashlib.sha256()
    for src in srcs:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib_path = _BUILD_DIR / f"librelp_kernels-{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, pid = _nvcc(), os.getpid()
        objs = [_BUILD_DIR / f"{src.stem}.{pid}.o" for src in srcs]
        tmp = lib_path.with_suffix(f".{pid}.tmp")
        t0 = time.perf_counter()
        logs = _run_all(
            [[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
             for src, obj in zip(srcs, objs)]
        )
        logs += _run_all(
            [[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              "-o", str(tmp), *map(str, objs)]]
        )
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = "".join(logs)
        os.replace(tmp, lib_path)
        for obj in objs:
            obj.unlink(missing_ok=True)
    _LIB = ctypes.CDLL(str(lib_path))
    return _LIB
