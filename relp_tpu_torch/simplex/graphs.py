"""Captured chunks: the port's counterpart of ``jax.jit`` over the JAX
package's device loops, the dense ``run_chunk`` and ``dual_run_chunk``
(``relp_tpu/simplex/kernels.py:327-386`` and ``:502-536``), the LU chunk
(``relp_tpu/simplex/lu.py:266-306``), the df32 chunk
(``relp_tpu/simplex/df_kernels.py:237-281``) and the PDHG chunk
(``relp_tpu/firstorder/pdhg.py:111-149``).

JAX compiles a chunk once per value of its static arguments and per
argument shapes, and runs it as one device program, a ``lax.while_loop``
over the iteration.  The port's chunk bodies (``kernels.run_chunk``,
``kernels.dual_run_chunk``, ``lu.lu_run_chunk``, ``df_kernels.
df_run_chunk``, ``pdhg._pdhg_chunk``) are fixed-length loops of eager torch
ops and kernel launches, a hundred to a thousand launches an iteration,
which the host issues more slowly than the card runs them.
``ChunkGraphs`` captures such a loop once as a CUDA graph and then replays
it: one graph launch a chunk.  The captured body is the eager one (with
``early_exit=False`` where it has one, as it runs on CUDA anyway), so a
replay computes what the eager chunk computes, with the same ops, kernels
and order.

A body is called ``body(state, **inputs, **static)``: ``state`` is a
``NamedTuple`` of tensors, ``inputs`` a dict of named tensors, ``static``
the Python values the body's control flow reads (every one has ``chunk``,
the iteration count), and it returns a ``NamedTuple`` of tensors.

* **Key**: the body, the state's type, the static arguments, the shape,
  dtype and device of every state field and input, and which inputs are
  one tensor (the dense chunk's A_scan is A_full): what
  ``static_argnames`` and the argument shapes key in JAX.  The LU chunk's
  static ``eta0``, the ring's fill at chunk entry, sets how many ring slots
  each eta loop runs, so an LU chunk is captured once per ``eta0`` seen.
* **Inputs**: static buffers, shared by the entries of one cache by role,
  shape and dtype.  The state is copied in before every replay; an input
  only when the tensor is not the one last copied (its identity, data
  pointer and ``_version``).
* **Outputs**: cloned out after every replay, so that a state the caller
  keeps (the driver's chunk-entry state, which it rolls back to) is never
  overwritten by a later replay.  A body that writes a state field in
  place (the LU chunk's eta ring) writes its own clone of the static
  buffer, never the caller's tensor.
* **Capture**: one warm-up iteration (``chunk=1``) on the static buffers,
  on the capture stream, makes the one-time work (cuBLAS and cuSOLVER
  handles and workspaces, the scan kernel's shared-memory attribute)
  happen outside the capture; the bodies have no branch that depends on
  the iteration, so one iteration runs every op of the chunk.  The warm-up
  and the capture are timed together.
* **Launch counts**: the scan wrapper counts a launch when its Python runs,
  which happens at capture only.  An entry records what its capture
  counted, and each replay adds that, so ``price_scan.LAUNCHES`` stays what
  eager execution gives; the warm-up's and the capture's own counts are
  taken back.  A steepest-edge capture of a body that prices through the
  scan kernel (the dense primal and the df32 chunk) on CUDA that counted no
  scan launch raises.
* **Lifetime**: a cache belongs to one engine, and so to one solve of one
  rung (or to one ``pdhg_solve`` call); its graphs, their memory pools and
  its static buffers go with it.  Inside ``shared(cache)`` every engine
  takes that one cache instead: ``solve_batch`` gives its single-LP
  fallbacks one cache for the call, so that a wave of node LPs of one
  shape captures each kind of chunk once, not once a node LP; it goes when
  the call returns.

An error in a capture or a replay propagates: nothing falls back to eager
execution or to a kernel's plain version.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import weakref
from collections import Counter
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from relp_tpu_torch.ops import price_scan
from relp_tpu_torch.simplex import df_kernels, kernels, lu

# The graph type, and the devices whose chunks the engines and
# ``pdhg_solve`` capture (the tests put a recording stand-in and the CPU
# here).
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
    """One captured chunk: its graph, its static outputs, the scan launches
    (by dtype) that one replay makes, and its static arguments."""

    def __init__(self, graph, outputs: NamedTuple, launches: Dict[str, int],
                 static: Dict[str, Any]):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.static = static


class ChunkGraphs:
    """The captured chunks of one engine (see the module docstring)."""

    def __init__(self):
        self._slots: Dict[Tuple, _Slot] = {}
        self._entries: Dict[Tuple, _Entry] = {}

    def run_chunk(self, state, A_scan, A_full, c, candidate_mask, *,
                  pricing: int, chunk: int, opt_tol: float, pivot_tol: float,
                  degen_tol: float, stop_at_zero: bool = False,
                  noisy_scan: bool = False):
        """``kernels.run_chunk`` (no shard) as a replayed graph."""
        return self.run(
            kernels.run_chunk, state,
            dict(A_scan=A_scan, A_full=A_full, c=c, candidate_mask=candidate_mask),
            must_scan=pricing == kernels.PRICE_STEEPEST,
            pricing=pricing, chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, stop_at_zero=stop_at_zero, noisy_scan=noisy_scan,
            early_exit=False,
        )

    def dual_run_chunk(self, state, A_scan, A_full, c, candidate_mask, *,
                       chunk: int, opt_tol: float, pivot_tol: float,
                       feas_tol: float, noisy_scan: bool = False):
        """``kernels.dual_run_chunk`` as a replayed graph."""
        return self.run(
            kernels.dual_run_chunk, state,
            dict(A_scan=A_scan, A_full=A_full, c=c, candidate_mask=candidate_mask),
            chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol, feas_tol=feas_tol,
            noisy_scan=noisy_scan, early_exit=False,
        )

    def lu_run_chunk(self, state, A_scan, A_full, c, candidate_mask, *,
                     pricing: int, chunk: int, opt_tol: float, pivot_tol: float,
                     degen_tol: float, stop_at_zero: bool = False,
                     eta0: Optional[int] = None):
        """``lu.lu_run_chunk`` (no shard) as a replayed graph, one per
        ``eta0`` (the ring's fill at entry, read here when not given)."""
        return self.run(
            lu.lu_run_chunk, state,
            dict(A_scan=A_scan, A_full=A_full, c=c, candidate_mask=candidate_mask),
            pricing=pricing, chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, stop_at_zero=stop_at_zero,
            eta0=int(state.eta_count) if eta0 is None else eta0, early_exit=False,
        )

    def df_run_chunk(self, state, A_scan, Ah, Al, ch, cl, candidate_mask, *,
                     pricing: int, chunk: int, opt_tol: float, pivot_tol: float,
                     degen_tol: float, stop_at_zero: bool = False,
                     noisy_scan: bool = False):
        """``df_kernels.df_run_chunk`` as a replayed graph."""
        return self.run(
            df_kernels.df_run_chunk, state,
            dict(A_scan=A_scan, Ah=Ah, Al=Al, ch=ch, cl=cl,
                 candidate_mask=candidate_mask),
            must_scan=pricing == kernels.PRICE_STEEPEST,
            pricing=pricing, chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, stop_at_zero=stop_at_zero, noisy_scan=noisy_scan,
            early_exit=False,
        )

    def captured(self, body: Callable, name: str) -> Counter:
        """{value of the static argument ``name``: captures} over this
        cache's entries of ``body`` (the LU chunk's captures by ``eta0``)."""
        return Counter(entry.static[name] for key, entry in self._entries.items()
                       if key[0] is body)

    def _slot(self, role: str, x: torch.Tensor) -> _Slot:
        key = (role, *_signature(x))
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = _Slot(x)
        return slot

    def run(self, body: Callable, state: NamedTuple, inputs: Dict[str, torch.Tensor],
            *, must_scan: bool = False, **static) -> NamedTuple:
        """``body(state, **inputs, **static)`` as a replayed graph, captured
        at the first call of its key; ``must_scan``: a capture on CUDA that
        launched no scan kernel raises."""
        global REPLAYS
        # Each input's role, or the role of the earlier input it is.
        alias = {}
        for role, x in inputs.items():
            alias[role] = next(r for r, y in inputs.items() if y is x)
        key = (body, type(state), tuple(sorted(static.items())),
               tuple(_signature(x) for x in state),
               tuple((role, alias[role], _signature(x)) for role, x in inputs.items()))
        state_slots = [self._slot(f"state.{name}", x)
                       for name, x in zip(state._fields, state)]
        slots = {role: self._slot(role, x) for role, x in inputs.items()
                 if alias[role] == role}
        for slot, x in zip(state_slots, state):
            slot.fill(x, always=True)
        for role, slot in slots.items():
            slot.fill(inputs[role], always=False)
        entry = self._entries.get(key)
        if entry is None:
            static_state = type(state)(*(slot.buffer for slot in state_slots))
            static_inputs = {role: slots[alias[role]].buffer for role in inputs}
            entry = self._entries[key] = self._capture(
                body, static_state, static_inputs, static, must_scan)
        entry.graph.replay()
        REPLAYS += 1
        _set_scan_counts({name: n + entry.launches[name]
                          for name, n in _scan_counts().items()})
        return type(entry.outputs)(*(x.clone() for x in entry.outputs))

    def _capture(self, body, state, inputs, static, must_scan: bool) -> _Entry:
        global CAPTURES, CAPTURE_SECONDS
        device = state[0].device
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
            body(state, **inputs, **dict(static, chunk=1))  # the warm-up
            if stream is not None:
                torch.cuda.synchronize(device)
            before = _scan_counts()
            graph.capture_begin()
            try:
                outputs = body(state, **inputs, **static)
            finally:
                graph.capture_end()
        if stream is not None:
            torch.cuda.current_stream(device).wait_stream(stream)
        launches = {name: n - before[name] for name, n in _scan_counts().items()}
        _set_scan_counts(counts)
        if must_scan and device.type == "cuda" and not launches["all"]:
            raise RuntimeError(
                f"captured a steepest-edge {body.__name__} that launched no scan kernel")
        CAPTURES += 1
        CAPTURE_SECONDS += time.perf_counter() - t0
        return _Entry(graph, outputs, launches, static)
