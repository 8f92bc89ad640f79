"""Spans the benchmark records around the program's calls, from its own
files, at run time.

``Recorder.wrapping()`` replaces, inside a ``with`` block, the module
attributes through which the program's entry points reach a solve:
``batch_driver.solve_batch`` and ``driver.solve_relaxation`` (read by the
lazy imports of branch and bound and of the batch driver's fallbacks) and
``certify_and_repair`` in both drivers.  Each top-level call becomes a
``Call`` with its clock, its LPs, how many were certified, their pivots and
their certification seconds; a batch's single-LP fallbacks count with the
batch, as ``chip_smoke.py``'s ``_counting_solves`` counts them.  The
certification spans label the device's idle gaps, and the float objective
of each single solve before its certification is kept for the comparison.
Nothing here changes what the program computes.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, NamedTuple, Optional


class Call(NamedTuple):
    kind: str  # "request" (one solve_general_form), "single" or "batch"
    t0: float
    t1: float
    lps: int
    certified: int
    iterations: int  # pivots, the dual simplex's included
    certify_s: float


def _summary(results):
    return (len(results), sum(bool(r.stats.certified) for r in results),
            sum(r.stats.iterations + r.stats.dual_iterations for r in results),
            sum(r.stats.certify_time_s for r in results))


@contextlib.contextmanager
def _replaced(module, name: str, wrapper: Callable):
    kept = getattr(module, name)
    setattr(module, name, wrapper(kept))
    try:
        yield
    finally:
        setattr(module, name, kept)


class Recorder:
    """The calls of a window, in order, and the spans of certification."""

    def __init__(self):
        self.calls: List[Call] = []
        # Every solve_relaxation call, nested in a request or a batch or not.
        self.solves: List[Call] = []
        self.certify_spans: List[tuple] = []
        # (float objective before certification, result) of each certified
        # single solve, in order.
        self.device_objectives: List[tuple] = []
        # Called with each Call as it ends (the tracer starts and stops
        # between calls).
        self.on_call: Optional[Callable[[Call], None]] = None
        # When a list: (provider, result) of every LP of a top-level call.
        self.keep: Optional[list] = None
        # Units of the cell's work done (requests, searches, families), and
        # a callable given the count after each.
        self.units = 0
        self.on_unit: Optional[Callable[[int], None]] = None
        self._inside = 0

    def add(self, call: Call) -> None:
        self.calls.append(call)
        if self.on_call is not None:
            self.on_call(call)

    def unit_done(self) -> None:
        """An entry finished one unit of its work."""
        self.units += 1
        if self.on_unit is not None:
            self.on_unit(self.units)

    def request(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` (a ``solve_general_form``) as one request."""
        self._inside += 1
        t0 = time.perf_counter()
        try:
            result, solution = fn(*args, **kwargs)
        finally:
            self._inside -= 1
        self.add(Call("request", t0, time.perf_counter(), *_summary([result])))
        return result, solution

    @contextlib.contextmanager
    def wrapping(self):
        from relp_tpu_torch.parallel import batch_driver
        from relp_tpu_torch.simplex import driver

        def batch(solve_batch):
            def run(providers, *args, **kwargs):
                self._inside += 1
                t0 = time.perf_counter()
                try:
                    results = solve_batch(providers, *args, **kwargs)
                finally:
                    self._inside -= 1
                if not self._inside:
                    self.add(Call("batch", t0, time.perf_counter(), *_summary(results)))
                    if self.keep is not None:
                        self.keep.extend(zip(providers, results))
                return results
            return run

        def single(solve_relaxation):
            def run(*args, **kwargs):
                self._inside += 1
                t0 = time.perf_counter()
                try:
                    result = solve_relaxation(*args, **kwargs)
                finally:
                    self._inside -= 1
                call = Call("single", t0, time.perf_counter(), *_summary([result]))
                self.solves.append(call)
                if not self._inside:
                    self.add(call)
                    if self.keep is not None:
                        self.keep.append((args[0] if args else kwargs["provider"],
                                          result))
                return result
            return run

        def certifying(keep_objective):
            def wrapper(certify_and_repair):
                def run(result, *args, **kwargs):
                    before = result.objective
                    t0 = time.perf_counter()
                    try:
                        return certify_and_repair(result, *args, **kwargs)
                    finally:
                        self.certify_spans.append((t0, time.perf_counter()))
                        if keep_objective:
                            self.device_objectives.append((before, result))
                return run
            return wrapper

        with _replaced(batch_driver, "solve_batch", batch), \
                _replaced(driver, "solve_relaxation", single), \
                _replaced(driver, "certify_and_repair", certifying(True)), \
                _replaced(batch_driver, "certify_and_repair", certifying(False)):
            yield self
