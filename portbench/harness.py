"""One run of one cell: set-up, the measured window, the reading of the
metrics, the comparison that decides ``correct``, and the result line.

Everything is found by name.  ``BENCHMARK.json`` at the root of the
checkout lists the cells and metrics; a cell is ``cells/<cell>.json``
(its configuration, entry, traffic parameters and limits), a
configuration ``configs/<config>.json`` (its sizes and source), an
end-to-end metric ``endtoend/<metric>.py`` and a per-layer metric
``metrics/<metric>.py`` (each a small reader of the window's record).  A
later cell, configuration or metric is a new file beside these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Modules the process must not hold once the window has closed, by whole
# top-level name: the JAX package, which the port is named after, and JAX.
REFUSED = ("jax", "jaxlib", "flax", "relp_tpu")


class NoCard(RuntimeError):
    """The cell asks for cards this machine does not have."""


class Registry:
    """The benchmark's files under ``root`` (the folder of this module, or
    another holding the same layout), and ``BENCHMARK.json``."""

    def __init__(self, root: Path = HERE, benchmark: Optional[Path] = None):
        self.root = Path(root)
        self.benchmark = json.loads(Path(benchmark or ROOT / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> Dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> Dict:
        return json.loads((self.root / "cells" / f"{name}.json").read_text())

    def config(self, name: str) -> Dict:
        return json.loads((self.root / "configs" / f"{name}.json").read_text())

    def reader(self, kind: str, name: str):
        """The module of ``<kind>/<name>.py`` (a name may hold dots)."""
        path = self.root / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def metrics(self, section: str, cell: str):
        """The metrics of ``section`` that ``cell`` reports: those whose
        ``workloads`` name it, or that have no ``workloads``."""
        return [m for m in self.benchmark[section]
                if cell in m.get("workloads", [cell])]


def card(torch, chips: int) -> Dict:
    """The card's record; raises NoCard without enough cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} CUDA card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "device_count": torch.cuda.device_count()}


def power_limit() -> str:
    """nvidia-smi's power.limit of card 0 (read once the window has closed,
    so that set-up holds no subprocess)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    return smi or "not read"


def refused_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(REFUSED))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             registry: Optional[Registry] = None, platform: Optional[str] = None,
             control: Optional[str] = None, also_controls=()) -> Dict:
    """One run; returns the result line's object.  ``platform`` "cpu" runs
    the program on the CPU with no card and no device record (the tests);
    ``control`` judges with the reference in that precision in the
    program's place; ``also_controls`` adds, under "controls", the checks
    each of those precisions gives on the same window (portbench.control)."""
    import torch

    from portbench.spans import Recorder
    from portbench.trace import ScanShapes, Tracer, breakdown

    registry = registry or Registry()
    workload = registry.workload(name)
    cell = registry.cell(name)
    cfg = registry.config(workload["config"])
    on_card = platform is None
    device = card(torch, workload["chips"]) if on_card else {
        "platform": "cpu", "kind": "cpu", "count": 0}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_card = time.perf_counter()
    entry = importlib.import_module(cell["entry"]).make(cfg, cell, seed, platform)
    t_made = time.perf_counter()
    shapes = ScanShapes()
    with shapes.kept():
        entry.warm_up()
    t_warm = time.perf_counter()
    print(f"setup: until the card was read {t_card - t_start:.3f} s, the entry and its "
          f"inputs {t_made - t_card:.3f} s, the warm-up {t_warm - t_made:.3f} s",
          file=sys.stderr, flush=True)
    tracer = None
    if trace and on_card:
        tracing = cell["trace"]
        tracer = Tracer(torch, tracing["start_after_share"] * seconds, tracing["seconds"])
        Tracer.warm(torch)
    from relp_tpu_torch.simplex import graphs

    recorder = Recorder()
    # The peak reserved memory after the set-up and a fixed number of the
    # window's units of work (0: at the window's start), so that it does not
    # grow with the units a faster program fits into the window.
    memory_after = cell["traffic"]["memory_after"]
    peak_at = {}

    def on_unit(done: int) -> None:
        if on_card and done == memory_after:
            peak_at["bytes"] = torch.cuda.max_memory_reserved()

    recorder.on_unit = on_unit
    counters0 = (graphs.CAPTURES, graphs.CAPTURE_SECONDS)
    if on_card:
        torch.cuda.synchronize()
        on_unit(0)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with recorder.wrapping(), shapes.kept():
        if tracer is not None:
            recorder.on_call = tracer.on_call
            tracer.open()
            entry.window(seconds, recorder)
            tracer.close()
        else:
            entry.window(seconds, recorder)
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved() if on_card else 0
    device["memory_peak_bytes"] = peak
    if on_card:
        device["power_limit"] = power_limit()
    attempted, failed = entry.attempted_failed()
    record = SimpleNamespace(
        seconds=window_s - (tracer.own_s if tracer else 0.0), setup_s=setup_s,
        peak_reserved_bytes=peak_at.get("bytes", peak), units=recorder.units,
        calls=recorder.calls, solves=recorder.solves,
        captures=graphs.CAPTURES - counters0[0],
        capture_s=graphs.CAPTURE_SECONDS - counters0[1],
        scan_shapes=sorted(shapes.shapes), trace=None)
    if tracer is not None:
        record.trace = tracer.summary(recorder)
    entry.free()
    del recorder
    if on_card:
        torch.cuda.empty_cache()
    checks = entry.judge(seed, control=control)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics(section, name):
        value = registry.reader("metrics" if trace else "endtoend", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": all(v <= limit for v, limit in checks.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if record.trace is not None:
        device["busy_s"] = record.trace["busy_s"]
        device["window_s"] = record.trace["window_s"]
        out["breakdown"] = breakdown(record.trace)
    if also_controls:
        out["controls"] = {p: {k: v for k, (v, _limit) in entry.judge(seed, control=p).items()}
                           for p in also_controls}
    out["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    return out
