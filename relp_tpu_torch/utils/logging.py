"""Observability: the port of ``relp_tpu.utils.logging``.

A standard-library logger named ``relp_tpu_torch``, and the port's span
recorder.

**Spans.**  A span is one piece of the program's work at a layer boundary:
its name, its start and end on ``time.perf_counter_ns()``, its own id, the
id of the span that encloses it (0 for none) and a request id, and a few
integer counts (pivots, LPs).  The enclosing span comes from a
``contextvars`` stack; a span with none is a root and opens a new request
id, which the spans inside it share.  ``span(name)`` is a context manager;
``start(name)`` / ``end(s)`` are the same as a pair, for a loop whose span
ends in one iteration and the next starts in another; ``traced(name)``
makes each call of a function a span; ``timed(name)`` also
times its block while recording is off, for the counters that are the sum
of a kind of span (``SolveStats.certify_time_s``,
``graphs.CAPTURE_SECONDS``).  A span is written when it ends, into a ring
of ``CAPACITY`` spans preallocated at import: a write over a held span
counts in ``DROPPED``.  ``spans()`` returns the held spans in order of
their start, ``window(t0, t1)`` those that overlap an interval, clipped to
it, and ``reset()`` empties the ring.  Recording is on from import;
``recording(False)`` turns it off, and a span then costs one read of a
module variable.

A ``gc.callbacks`` hook records one ``gc`` span for each collection of
the oldest generation, with the objects it collected.

``epoch_offset_ns()`` maps the span clock onto ``time.time_ns()``, the
clock of ``torch.profiler``'s (Kineto's) timestamps, so that a span can be
placed on a device trace's timeline.
"""

from __future__ import annotations

import contextvars
import functools
import gc
import itertools
import logging
import os
from time import perf_counter_ns, time_ns
from typing import Dict, List, NamedTuple, Optional

_LOGGER_NAME = "relp_tpu_torch"


def get_logger(child: Optional[str] = None) -> logging.Logger:
    name = f"{_LOGGER_NAME}.{child}" if child else _LOGGER_NAME
    logger = logging.getLogger(name)
    if not logging.getLogger(_LOGGER_NAME).handlers:
        level = os.environ.get("RELP_TPU_LOG", "WARNING").upper()
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        root = logging.getLogger(_LOGGER_NAME)
        root.addHandler(handler)
        root.setLevel(level)
    return logger


class Span(NamedTuple):
    name: str
    start: int  # perf_counter_ns
    end: int
    id: int
    parent: int  # 0: a root
    request: int
    counts: Dict[str, int]
    tag: Optional[str]  # a detail, such as the body a graph captured


CAPACITY = 1 << 17
_MASK = CAPACITY - 1
# Spans written over while the ring still held them, since the last reset.
DROPPED = 0
_ON = True
# Each slot holds a Span's fields as a plain tuple (cheaper to make), or None.
_ring: List[Optional[tuple]] = [None] * CAPACITY
_writes = itertools.count()
_ids = itertools.count(1)
_requests = itertools.count(1)
# (id, request) of the innermost open span of this context.
_current: contextvars.ContextVar = contextvars.ContextVar(
    "relp_tpu_torch_span", default=(0, 0))


def _write(fields: tuple) -> int:
    global DROPPED
    slot = next(_writes) & _MASK
    if _ring[slot] is not None:
        DROPPED += 1
    _ring[slot] = fields
    return slot


class _Span:
    """An open span (``span``, ``start``, ``timed``); ``keep`` False times
    the block without recording it."""

    __slots__ = ("name", "tag", "keep", "counts", "start", "end", "id", "parent",
                 "request", "_token", "_slot")

    def __init__(self, name: str, tag: Optional[str] = None, keep: bool = True):
        self.name, self.tag, self.keep, self.counts, self._slot = name, tag, keep, None, -1

    def __enter__(self) -> "_Span":
        if self.keep:
            self.parent, request = _current.get()
            self.id = next(_ids)
            self.request = request if self.parent else next(_requests)
            self._token = _current.set((self.id, self.request))
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *_exc) -> bool:
        self.end = perf_counter_ns()
        if self.keep:
            _current.reset(self._token)
            self._slot = _write((self.name, self.start, self.end, self.id, self.parent,
                                 self.request, self.counts, self.tag))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def count(self, **counts: int) -> None:
        """Add to the span's counts, also once it has ended, while the ring
        still holds it."""
        if self.counts is None:
            self.counts = {}
        for key, n in counts.items():
            self.counts[key] = self.counts.get(key, 0) + n
        held = _ring[self._slot] if self._slot >= 0 else None
        if held is not None and held[3] == self.id:
            _ring[self._slot] = held[:6] + (self.counts,) + held[7:]


class _NoSpan:
    """What ``span`` and ``start`` return while recording is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *_exc) -> bool:
        return False

    def count(self, **_counts: int) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, tag: Optional[str] = None):
    """``with span(name) as s: ...`` records the block as a span;
    ``s.count(pivots=n)`` adds to its counts."""
    if not _ON:
        return _NO_SPAN
    return _Span(name, tag)


def start(name: str, tag: Optional[str] = None):
    """Open a span that ``end`` closes."""
    if not _ON:
        return _NO_SPAN
    return _Span(name, tag).__enter__()


def end(s, **counts: int) -> None:
    """Close a span that ``start`` opened (None: none), adding ``counts``."""
    if s is not None and s is not _NO_SPAN:
        if counts:
            s.count(**counts)
        s.__exit__()


def timed(name: str, tag: Optional[str] = None) -> _Span:
    """``span`` whose ``seconds`` is read after the block, recording on or
    off."""
    return _Span(name, tag, keep=_ON)


def traced(name: str):
    """A decorator: each call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def add(name: str, start_ns: int, end_ns: int, **counts: int) -> None:
    """Record a span that has ended, inside the innermost open span."""
    if not _ON:
        return
    parent, request = _current.get()
    _write((name, start_ns, end_ns, next(_ids), parent,
            request if parent else next(_requests), counts, None))


def recording(on: bool) -> bool:
    """Turn recording on or off; returns whether it was on."""
    global _ON
    was, _ON = _ON, bool(on)
    return was


def reset() -> None:
    """Empty the ring and zero ``DROPPED``."""
    global DROPPED
    _ring[:] = [None] * CAPACITY
    DROPPED = 0


def spans() -> List[Span]:
    """The held spans, in order of their start (as the ring held them when
    called: a collection while this builds them writes after)."""
    held = [s for s in _ring if s is not None]
    return sorted((Span(*s[:6], s[6] or {}, s[7]) for s in held),
                  key=lambda s: (s.start, s.id))


def window(start_ns: int, end_ns: int) -> Optional[List[Span]]:
    """The held spans that overlap [start_ns, end_ns], each clipped to it,
    in order of their start; None where the ring has lost spans of the
    interval (it dropped some, and the oldest it holds starts after
    ``start_ns``)."""
    dropped = DROPPED
    held = spans()
    if dropped and (not held or held[0].start > start_ns):
        return None
    return [s._replace(start=max(s.start, start_ns), end=min(s.end, end_ns))
            for s in held if s.start < end_ns and s.end > start_ns]


def self_ns(spans: List[Span]) -> Dict[int, int]:
    """Each span's self time: its duration less the part of it that the
    union of its children among ``spans`` covers."""
    children: Dict[int, list] = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        covered, edge = 0, s.start
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start):
            lo, hi = max(c.start, edge), min(c.end, s.end)
            if hi > lo:
                covered += hi - lo
                edge = hi
        out[s.id] = s.end - s.start - covered
    return out


def epoch_offset_ns(reads: int = 16) -> int:
    """``time.time_ns() - perf_counter_ns()``, from the tightest of
    ``reads`` reads of the wall clock bracketed by two of the span clock."""
    best = None
    for _ in range(reads):
        a = perf_counter_ns()
        wall = time_ns()
        b = perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


_gc_start = 0


def _on_gc(phase: str, info: dict) -> None:
    global _gc_start
    if info["generation"] != 2 or not _ON:
        return
    if phase == "start":
        _gc_start = perf_counter_ns()
    else:
        add("gc", _gc_start, perf_counter_ns(), collected=info["collected"])


gc.callbacks.append(_on_gc)
