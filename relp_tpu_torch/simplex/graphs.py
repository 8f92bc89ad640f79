"""Captured simplex chunks: the port's counterpart of ``jax.jit`` over the
JAX package's ``run_chunk`` and ``dual_run_chunk``
(``relp_tpu/simplex/kernels.py:327-386`` and ``:502-536``).

JAX compiles a chunk once per value of its static arguments and per
argument shapes, and runs it as one device program, a ``lax.while_loop``
over the iteration.  The port's chunk (``kernels.run_chunk``,
``kernels.dual_run_chunk``) is a fixed-length loop of eager torch ops and
kernel launches, about a hundred launches a pivot, which the host issues
more slowly than the card runs them.  ``ChunkGraphs`` captures that loop
once as a CUDA graph and then replays it: one graph launch a chunk.  The
captured body is the eager one (with ``early_exit=False``, as it runs on
CUDA anyway), so a replay computes what the eager chunk computes, with the
same ops, kernels and order.

* **Key**: primal or dual, the static arguments (pricing, chunk, opt_tol,
  pivot_tol, degen_tol or feas_tol, stop_at_zero, noisy_scan), whether
  A_scan is A_full, and the shape, dtype and device of every input: what
  ``static_argnames`` and the argument shapes key in JAX.
* **Inputs**: static buffers, shared by the entries of one cache by role,
  shape and dtype.  The state is copied in before every replay; A_scan,
  A_full, c and candidate_mask only when the tensor is not the one last
  copied (its identity, data pointer and ``_version``).
* **Outputs**: cloned out after every replay, so that a state the caller
  keeps (the driver's chunk-entry state, which it rolls back to) is never
  overwritten by a later replay.
* **Capture**: one warm-up iteration on the static buffers, on the capture
  stream, makes the one-time work (cuBLAS handles and workspaces, the scan
  kernel's shared-memory attribute) happen outside the capture; the body
  has no branch that depends on the iteration, so one iteration runs every
  op of the chunk.  The warm-up and the capture are timed together.
* **Launch counts**: the scan wrapper counts a launch when its Python runs,
  which happens at capture only.  An entry records what its capture
  counted, and each replay adds that, so ``price_scan.LAUNCHES`` stays what
  eager execution gives; the warm-up's and the capture's own counts are
  taken back.  A steepest-edge primal capture on CUDA that counted no scan
  launch raises.
* **Lifetime**: a cache belongs to one engine, and so to one solve of one
  rung; its graphs, their memory pools and its static buffers go with it.
  Inside ``shared(cache)`` every engine takes that one cache instead:
  ``solve_batch`` gives its single-LP fallbacks one cache for the call, so
  that a wave of node LPs of one shape captures each kind of chunk once,
  not once a node LP; it goes when the call returns.

An error in a capture or a replay propagates: nothing falls back to eager
execution or to a kernel's plain version.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import weakref
from typing import Dict, Optional, Tuple

import torch

from relp_tpu_torch.ops import price_scan
from relp_tpu_torch.simplex import kernels
from relp_tpu_torch.simplex.state import SimplexState

# The graph type, and the devices whose chunks ``DenseEngine`` captures (the
# tests put a recording stand-in and the CPU here).
Graph = torch.cuda.CUDAGraph
DEVICE_TYPES = ("cuda",)

# Captures, replays and capture seconds (warm-up included) since the last
# reset, over every cache.
CAPTURES = 0
REPLAYS = 0
CAPTURE_SECONDS = 0.0

# One capture stream a card, reused by every cache (a new stream would get
# cuBLAS workspaces of its own).
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}

# The cache of the innermost ``shared`` block, if any.
_SHARED: contextvars.ContextVar[Optional["ChunkGraphs"]] = contextvars.ContextVar(
    "relp_tpu_torch_shared_chunk_graphs", default=None)


@contextlib.contextmanager
def shared(chunk_graphs: "ChunkGraphs"):
    """Engines whose first chunk runs inside the block take ``chunk_graphs``."""
    token = _SHARED.set(chunk_graphs)
    try:
        yield
    finally:
        _SHARED.reset(token)


def cache() -> "ChunkGraphs":
    """The cache for a new engine: the ``shared`` block's, else its own."""
    return _SHARED.get() or ChunkGraphs()


def _signature(x: torch.Tensor) -> Tuple:
    return tuple(x.shape), x.dtype, str(x.device)


def _scan_counts() -> Dict[str, int]:
    """The scan wrapper's counts, its total under the key ``"all"``."""
    return {"all": price_scan.LAUNCHES, **price_scan.LAUNCHES_BY_DTYPE}


def _set_scan_counts(counts: Dict[str, int]) -> None:
    counts = dict(counts)
    price_scan.LAUNCHES = counts.pop("all")
    price_scan.LAUNCHES_BY_DTYPE.update(counts)


class _Slot:
    """A static input buffer and the tensor last copied into it."""

    def __init__(self, like: torch.Tensor):
        self.buffer = torch.empty_like(like, memory_format=torch.contiguous_format)
        self._source = None
        self._ptr = self._version = None

    def fill(self, x: torch.Tensor, always: bool) -> None:
        if (not always and self._source is not None and self._source() is x
                and x.data_ptr() == self._ptr and x._version == self._version):
            return
        self.buffer.copy_(x)
        self._source = weakref.ref(x)
        self._ptr, self._version = x.data_ptr(), x._version


class _Entry:
    """One captured chunk: its graph, its static outputs, and the scan
    launches (by dtype) that one replay makes."""

    def __init__(self, graph, outputs: SimplexState, launches: Dict[str, int]):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches


class ChunkGraphs:
    """The captured chunks of one engine (see the module docstring)."""

    def __init__(self):
        self._slots: Dict[Tuple, _Slot] = {}
        self._entries: Dict[Tuple, _Entry] = {}

    def run_chunk(self, state: SimplexState, A_scan, A_full, c, candidate_mask, *,
                  pricing: int, chunk: int, opt_tol: float, pivot_tol: float,
                  degen_tol: float, stop_at_zero: bool = False,
                  noisy_scan: bool = False) -> SimplexState:
        """``kernels.run_chunk`` (no shard) as a replayed graph."""
        return self._run(
            kernels.run_chunk, state, A_scan, A_full, c, candidate_mask,
            dict(pricing=pricing, chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
                 degen_tol=degen_tol, stop_at_zero=stop_at_zero,
                 noisy_scan=noisy_scan),
        )

    def dual_run_chunk(self, state: SimplexState, A_scan, A_full, c, candidate_mask,
                       *, chunk: int, opt_tol: float, pivot_tol: float,
                       feas_tol: float, noisy_scan: bool = False) -> SimplexState:
        """``kernels.dual_run_chunk`` as a replayed graph."""
        return self._run(
            kernels.dual_run_chunk, state, A_scan, A_full, c, candidate_mask,
            dict(chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
                 feas_tol=feas_tol, noisy_scan=noisy_scan),
        )

    def _slot(self, role: str, x: torch.Tensor) -> _Slot:
        key = (role, *_signature(x))
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = _Slot(x)
        return slot

    def _run(self, body, state, A_scan, A_full, c, candidate_mask, static):
        global REPLAYS
        shared = A_scan is A_full
        inputs = {"A_full": A_full, "c": c, "candidate_mask": candidate_mask}
        if not shared:
            inputs["A_scan"] = A_scan
        key = (body.__name__, tuple(sorted(static.items())), shared,
               tuple(_signature(x) for x in state),
               tuple((role, _signature(x)) for role, x in inputs.items()))
        state_slots = [self._slot(f"state.{name}", x)
                       for name, x in zip(SimplexState._fields, state)]
        slots = {role: self._slot(role, x) for role, x in inputs.items()}
        for slot, x in zip(state_slots, state):
            slot.fill(x, always=True)
        for role, slot in slots.items():
            slot.fill(inputs[role], always=False)
        entry = self._entries.get(key)
        if entry is None:
            static_state = SimplexState(*(slot.buffer for slot in state_slots))
            A_full_s = slots["A_full"].buffer
            A_scan_s = A_full_s if shared else slots["A_scan"].buffer
            entry = self._entries[key] = self._capture(
                body, static_state, A_scan_s, A_full_s, slots["c"].buffer,
                slots["candidate_mask"].buffer, static)
        entry.graph.replay()
        REPLAYS += 1
        _set_scan_counts({name: n + entry.launches[name]
                          for name, n in _scan_counts().items()})
        return SimplexState(*(x.clone() for x in entry.outputs))

    def _capture(self, body, state, A_scan, A_full, c, candidate_mask,
                 static) -> _Entry:
        global CAPTURES, CAPTURE_SECONDS
        device = state.Binv.device
        args = (state, A_scan, A_full, c, candidate_mask)
        counts = _scan_counts()
        t0 = time.perf_counter()
        graph = Graph()
        stream, on_stream = None, contextlib.nullcontext()
        if device.type == "cuda":
            stream = _STREAMS.get(device.index)
            if stream is None:
                stream = _STREAMS[device.index] = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            on_stream = torch.cuda.stream(stream)
        with on_stream:
            body(*args, early_exit=False, **dict(static, chunk=1))  # the warm-up
            if stream is not None:
                torch.cuda.synchronize(device)
            before = _scan_counts()
            graph.capture_begin()
            try:
                outputs = body(*args, early_exit=False, **static)
            finally:
                graph.capture_end()
        if stream is not None:
            torch.cuda.current_stream(device).wait_stream(stream)
        launches = {name: n - before[name] for name, n in _scan_counts().items()}
        _set_scan_counts(counts)
        if (body is kernels.run_chunk and static["pricing"] == kernels.PRICE_STEEPEST
                and device.type == "cuda" and not launches["all"]):
            raise RuntimeError(
                "captured a steepest-edge chunk that launched no scan kernel")
        CAPTURES += 1
        CAPTURE_SECONDS += time.perf_counter() - t0
        return _Entry(graph, SimplexState(*outputs), launches)
