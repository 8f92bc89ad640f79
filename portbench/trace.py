"""The device trace of a steady part of the window, and its reduction.

``Tracer`` runs ``torch.profiler`` with CUDA activity only (host activity
would record every torch op of a solve and slow it) from the end of the
first program call after ``start_after`` seconds of the window to the end
of the first call after ``length`` seconds more, or to the window's close.
The raw Kineto events are read, as ``chip_smoke.py``'s ``_device_busy``
reads them.  The reduction gives the seconds in which any device operation
ran (the union of their intervals), the traced window, each kernel's count
and seconds, and the longest idle gaps labelled by the harness's spans
(Kineto's clock is ``time.time_ns``'s).  ``ScanShapes`` keeps the shapes
given to ``kernels.fused_price_scan`` from the warm-up to the window's
close, so that the scan's bound can be counted per traced launch, also
where the traced part replays graphs captured before it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class Tracer:
    def __init__(self, torch, start_after: float, length: float):
        self.torch = torch
        self.start_after = start_after
        self.length = length
        self.window0 = None
        self._prof = None
        self.t0 = self.t1 = None  # perf_counter at start and stop
        self._epoch0 = None  # (time.time_ns, perf_counter) at start
        self.scan_launches = 0
        self._launches0 = 0
        # Seconds the window spent starting and stopping the profiler: the
        # per-layer shares leave them out.
        self.own_s = 0.0

    @staticmethod
    def warm(torch) -> None:
        """Start CUPTI once in set-up, so the window's first trace does not
        pay for it."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def open(self) -> None:
        """The window starts."""
        self.window0 = time.perf_counter()

    def tracing(self) -> bool:
        return self._prof is not None and self.t1 is None

    def on_call(self, _call=None) -> None:
        """Between two program calls: start or stop."""
        now = time.perf_counter()
        if self._prof is None and now - self.window0 >= self.start_after:
            self._start()
        elif self.tracing() and now - self.t0 >= self.length:
            self.close()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        from relp_tpu_torch.ops import price_scan

        start = time.perf_counter()
        self.torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._launches0 = price_scan.LAUNCHES
        self.t0 = time.perf_counter()
        self.own_s += self.t0 - start
        self._epoch0 = (time.time_ns(), self.t0)

    def close(self) -> None:
        """Stop, if tracing (at the window's close too)."""
        if not self.tracing():
            return
        from relp_tpu_torch.ops import price_scan

        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.scan_launches = price_scan.LAUNCHES - self._launches0
        self._prof.stop()
        self.own_s += time.perf_counter() - self.t1

    def summary(self, recorder) -> Optional[Dict]:
        """busy_s, window_s, kernels {name: [count, seconds]}, the idle gaps
        (longest first, labelled), the scan's launches and shapes; None if
        nothing was traced."""
        if self.t1 is None:
            return None
        from torch.autograd import DeviceType

        events = [(e.name(), e.start_ns(), e.duration_ns())
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        ns0, pc0 = self._epoch0
        to_pc = lambda ns: pc0 + (ns - ns0) / 1e9  # noqa: E731
        spans = sorted((to_pc(s), to_pc(s + d)) for _n, s, d in events)
        busy, gaps = 0.0, []
        edge = self.t0
        for s, e in spans:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= edge:
                continue
            if s > edge:
                gaps.append((s - edge, edge))
                busy += e - s
            else:
                busy += e - edge
            edge = e
        if self.t1 > edge:
            gaps.append((self.t1 - edge, edge))
        kernels = defaultdict(lambda: [0, 0.0])
        for name, _s, d in events:
            kernels[name][0] += 1
            kernels[name][1] += d / 1e9
        gaps.sort(reverse=True)
        return dict(
            window_s=self.t1 - self.t0, busy_s=busy, kernels=dict(kernels),
            idle_gaps=[[_label(recorder, start, start + length), length]
                       for length, start in gaps[:10]],
            scan_launches=self.scan_launches)


class ScanShapes:
    """(M, N, itemsize) of each call of ``kernels.fused_price_scan`` inside
    ``kept()``: eager calls and graph captures (a replay launches what its
    capture recorded)."""

    def __init__(self):
        self.shapes = set()

    @contextlib.contextmanager
    def kept(self):
        from relp_tpu_torch.simplex import kernels

        kept = kernels.fused_price_scan

        def run(P, A, *args, **kwargs):
            self.shapes.add((int(A.shape[0]), int(A.shape[1]), int(A.element_size())))
            return kept(P, A, *args, **kwargs)

        kernels.fused_price_scan = run
        try:
            yield
        finally:
            kernels.fused_price_scan = kept


def _label(recorder, start: float, end: float) -> str:
    """What the host spent most of the gap [start, end) on (perf_counter),
    by the spans, read at 25 points across it."""
    points = [_label_at(recorder, start + (end - start) * (k + 0.5) / 25) for k in range(25)]
    return max(set(points), key=points.count)


def _label_at(recorder, t: float) -> str:
    """What the host was doing at perf_counter ``t``, by the spans."""
    if any(t0 <= t < t1 for t0, t1 in recorder.certify_spans):
        return "certification"
    if any(c.t0 <= t < c.t1 for c in recorder.solves):
        return "single-LP driver host"
    for c in recorder.calls:
        if c.t0 <= t < c.t1:
            return {"batch": "batch driver host",
                    "request": "host pipeline (presolve, standardize, lowering)",
                    "single": "single-LP driver host"}[c.kind]
    return "between calls (branch and bound, the harness)"


def breakdown(summary: Dict) -> Dict:
    """The result line's breakdown: the ten costliest device operations and
    the ten longest idle gaps, in seconds."""
    ops = sorted(((name[:120], s) for name, (_n, s) in summary["kernels"].items()),
                 key=lambda kv: kv[1], reverse=True)[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": summary["idle_gaps"]}
