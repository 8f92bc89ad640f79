"""Captured chunks: the port's counterpart of ``jax.jit`` over the JAX
package's device loops, the dense ``run_chunk`` and ``dual_run_chunk``
(``relp_tpu/simplex/kernels.py:327-386`` and ``:502-536``), the LU chunk
(``relp_tpu/simplex/lu.py:266-306``), the df32 chunk
(``relp_tpu/simplex/df_kernels.py:237-281``), the PDHG chunk
(``relp_tpu/firstorder/pdhg.py:111-149``), and the batch driver's steps
and chunks: its module-level ``_batch_step`` (a chunk of pivots, through
the batched-pivot kernels or the batched torch path, and the Newton and
gamma refreshes; ``relp_tpu/parallel/batch_driver.py:89-97``) and the
batched dual and polish chunks (``relp_tpu/parallel/batch.py:154-158``,
``:213-221``).

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
the iteration count), and it returns a ``NamedTuple`` of tensors (the
batch step: that and its report, a tensor).

* **Key**: the body, the state's type, the static arguments, the shape,
  dtype, device and strides of every state field and input, which
  inputs are one tensor (the dense chunk's A_scan is A_full) and the
  identity of an input read in place (``bound``, below): what
  ``static_argnames`` and the argument shapes key in JAX.  On a card the
  LU chunk's passes through the eta ring are one kernel launch each that
  reads the ring's fill on the device, so an LU chunk is captured once
  (its key's ``eta0`` None); where the plain eta loops run (the CPU), the
  static ``eta0``, the ring's fill at chunk entry, sets how many ring slots
  each loop runs, and an LU chunk is captured once per ``eta0`` seen.
* **Inputs**: static buffers, shared by the entries of one cache by role,
  shape, dtype and strides, each laid out as its tensor is.  A tensor
  expanded over its leading dimension (stride 0: ``solve_batch``'s one
  shared tableau) gets one buffer of a single slice, expanded as the
  tensor is, so that a (B, M, N) tableau stays M N elements.  The state
  is copied in before every replay; an input only when the tensor is not
  the one last copied (its identity, data pointer and ``_version``).  An
  input named in ``bound`` (``solve_batch``'s B stacked tableaus) gets no
  buffer: the graph reads the caller's tensor in place, the key holds
  that tensor's identity, the entry holds the tensor, and ``release``
  drops the entry when the caller is done with it.
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
* **Launch counts**: a kernel wrapper counts a launch when its Python
  runs, which happens at capture only.  An entry records what its capture
  counted on every counter (the scan's, in all and by dtype, the two
  batched-pivot kernels', the two eta-ring kernels' and the mesh's
  collectives), and each replay adds that, so every counter stays what
  eager execution gives; the
  warm-up's and the capture's own counts are taken back.  A replay's
  count is this bookkeeping, not an observation of the replay: what shows
  that a replay ran the kernel is its output, equal to the eager step's
  bit for bit, or a profiler trace of the replay.  A capture on CUDA of a
  body that must launch a kernel (``must_launch``: the scan for a
  steepest-edge dense primal or df32 chunk, the batched-pivot kernel of
  the kernel route's step, the eta-ring FTRAN for the LU chunk) that
  counted no launch of it raises.
* **Lifetime**: a cache belongs to one engine, and so to one solve of one
  rung (or to one ``pdhg_solve`` call); its graphs, their memory pools and
  its static buffers go with it.  Inside ``shared(cache)`` every engine
  takes that one cache instead: ``solve_batch`` gives its single-LP
  fallbacks one cache for the call, so that a wave of node LPs of one
  shape captures each kind of chunk once, not once a node LP; it goes when
  the call returns.  The batch driver's steps and chunks replay from one
  cache for the process (``steps()``), as the JAX package jits them at
  module scope: a MIP calls ``solve_batch`` once a node wave, and waves of
  one shape capture each step once.  That cache runs a key eagerly at its
  first use and captures it at its second, so that a step taken once (a
  one-off call's phase 1, a call's polish) costs what an eager step costs
  and no capture.  It is bounded by bytes: past ``STEP_CACHE_BYTES`` (its
  graphs' memory pools, as the capture grew the card's reserved memory,
  its static buffers and the tensors its entries read in place) it evicts
  the least recently used entries, each with its graph, its memory pool,
  its static outputs and the static input buffers no other entry uses.

* **Meshes**: under a mesh the chunks and steps are captured as without
  one, with their collectives (``parallel.sharded``'s all_reduce and
  all_gather, NCCL's kernels) inside the graph: the dense and LU chunks
  and the batch steps take the rank's ``ColumnShard`` as a static
  argument, the PDHG chunk its ``_Grid``.  The one-iteration warm-up runs
  the collectives eagerly first, so the communicator exists before the
  capture; a capture with a process group up refuses unsafe calls of its
  own thread only (``thread_local``), since the process group's watchdog
  thread queries CUDA events meanwhile.  Every rank of a group must
  capture, replay or run eagerly the same chunk at the same point, or the
  collectives of different ranks stop matching.  An engine's cache and a
  ``pdhg_solve`` call's capture every key at its first use, and every
  rank sees the same keys in the same order (on the CPU the ring's fill
  ``eta0`` is replicated), so they decide alike.  The steps of a mesh go
  to a cache of their own, ``steps(group)`` for the column group of their
  shard, whose
  decisions rest on the order of keys, the same on every rank, and on one
  fact that is not: the bytes it holds.  Before every eviction its ranks
  agree on that as its largest value over the group.  Each such cache has
  a bound of ``STEP_CACHE_BYTES`` of its own and lives until
  ``release_group`` drops it, which ``parallel.shutdown_multihost`` does
  for every group before it destroys the process groups.  On the CPU
  (gloo) everything runs eagerly, as without a mesh.

An error in a capture or a replay propagates: nothing falls back to eager
execution or to a kernel's plain version.
"""

from __future__ import annotations

import contextlib
import contextvars
import weakref
from collections import Counter, OrderedDict
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from relp_tpu_torch.ops import batch_pivot, eta_ring, price_scan
from relp_tpu_torch.simplex import df_kernels, kernels, lu
from relp_tpu_torch.utils import logging as trace

# The graph type, and the devices whose chunks the engines and
# ``pdhg_solve`` capture (the tests put a recording stand-in and the CPU
# here).
Graph = torch.cuda.CUDAGraph
DEVICE_TYPES = ("cuda",)

# Captures, replays and capture seconds (warm-up included) since the last
# reset, over every cache, and the entries the bounded cache evicted.  The
# capture seconds are the sum of the ``graph.capture`` spans' durations.
CAPTURES = 0
REPLAYS = 0
CAPTURE_SECONDS = 0.0
EVICTIONS = 0

# The bytes each cache of the batch driver's steps may hold (graph pools,
# static buffers, tensors read in place), a twentieth of an 80 GB card:
# the process-wide cache of unsharded steps, and each column group's cache
# of sharded steps, each bounded alone, so that a process holds at most
# this times one more than the groups whose caches are up
# (``release_group`` drops a group's).  chip_smoke's paths hold at most a
# few hundred MB (``step_cache_MB`` on its lines; PERF.md).
STEP_CACHE_BYTES = 4 << 30
# Keys the cache of steps remembers having run once (eagerly).
_SEEN_LIMIT = 4096
_STEPS: Optional["ChunkGraphs"] = None
# The caches of sharded steps, one for each process group of a mesh's
# columns, each until ``release_group``.
_GROUP_STEPS: Dict[Any, "ChunkGraphs"] = {}

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


def steps(group=None) -> "ChunkGraphs":
    """The process-wide, bounded cache of the batch driver's steps; with
    ``group`` (the process group of a mesh's columns) the cache of the
    steps sharded over that group, whose ranks agree on every eviction,
    bounded by ``STEP_CACHE_BYTES`` of its own and kept until
    ``release_group(group)``."""
    global _STEPS
    if group is not None:
        cache = _GROUP_STEPS.get(group)
        if cache is None:
            cache = _GROUP_STEPS[group] = ChunkGraphs(
                max_bytes=STEP_CACHE_BYTES, second_use=True, group=group)
        return cache
    if _STEPS is None:
        _STEPS = ChunkGraphs(max_bytes=STEP_CACHE_BYTES, second_use=True)
    return _STEPS


def release_group(group=None) -> None:
    """Drop the cache of the steps sharded over ``group`` (every group's
    with None): its graphs, memory pools and static buffers.  Its graphs
    hold the group's collectives, so a process drops them before it
    destroys the group; ``parallel.shutdown_multihost`` does so for every
    group."""
    for key in ([group] if group is not None else list(_GROUP_STEPS)):
        cache = _GROUP_STEPS.pop(key, None)
        if cache is not None:
            cache.clear()


def _signature(x: torch.Tensor) -> Tuple:
    return tuple(x.shape), x.dtype, str(x.device), x.stride()


def _expanded(x: torch.Tensor) -> bool:
    """One slice expanded over the leading dimension (batch stride 0)."""
    return x.dim() > 1 and x.stride(0) == 0


def _reserved(device: torch.device) -> int:
    """The card's reserved memory (0 off CUDA): its growth over a capture
    is the graph's memory pool."""
    return torch.cuda.memory_reserved(device) if device.type == "cuda" else 0


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter: the scan's in all
    (``"scan"``) and by dtype (``"scan_<dtype>"``), the batched-pivot
    kernels' (``"resident"``, ``"blocked"``), the eta-ring kernels'
    (``"eta_ftran"``, ``"eta_btran"`` of one vector, ``"eta_btran_pair"``);
    and the mesh's collectives
    (``"collectives"``, ``parallel.sharded.COLLECTIVES``)."""
    from relp_tpu_torch.parallel import sharded  # the package imports this module

    return {"scan": price_scan.LAUNCHES,
            **{f"scan_{name}": n for name, n in price_scan.LAUNCHES_BY_DTYPE.items()},
            "resident": batch_pivot.LAUNCHES_RESIDENT,
            "blocked": batch_pivot.LAUNCHES_BLOCKED,
            **{f"eta_{kind}": n for kind, n in eta_ring.LAUNCHES.items()},
            "collectives": sharded.COLLECTIVES}


def _set_launch_counts(counts: Dict[str, int]) -> None:
    from relp_tpu_torch.parallel import sharded

    price_scan.LAUNCHES = counts["scan"]
    for name in price_scan.LAUNCHES_BY_DTYPE:
        price_scan.LAUNCHES_BY_DTYPE[name] = counts[f"scan_{name}"]
    batch_pivot.LAUNCHES_RESIDENT = counts["resident"]
    batch_pivot.LAUNCHES_BLOCKED = counts["blocked"]
    for kind in eta_ring.LAUNCHES:
        eta_ring.LAUNCHES[kind] = counts[f"eta_{kind}"]
    sharded.COLLECTIVES = counts["collectives"]


class _Slot:
    """A static input buffer, laid out as the tensor it was made for (one
    slice expanded over the leading dimension stays one slice), and the
    tensor last copied into it."""

    def __init__(self, like: torch.Tensor):
        if _expanded(like):
            self._base = torch.empty_like(like[0])
            self.buffer = self._base.expand(like.shape)
        else:
            self.buffer = self._base = torch.empty_like(like)
        self.nbytes = self._base.untyped_storage().nbytes()
        self._source = None
        self._ptr = self._version = None

    def fill(self, x: torch.Tensor, always: bool) -> None:
        if (not always and self._source is not None and self._source() is x
                and x.data_ptr() == self._ptr and x._version == self._version):
            return
        self._base.copy_(x[0] if self._base is not self.buffer else x)
        self._source = weakref.ref(x)
        self._ptr, self._version = x.data_ptr(), x._version


class _Entry:
    """One captured chunk: its graph, its static outputs, the launches (by
    counter) that one replay makes, its static arguments, the keys of the
    slots it reads, the tensors it reads in place and the bytes of its
    memory pool."""

    def __init__(self, graph, outputs, launches: Dict[str, int],
                 static: Dict[str, Any], slots: Tuple, bound: Tuple, pool_bytes: int):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.static = static
        self.slots = slots
        self.bound = bound
        self.pool_bytes = pool_bytes


class ChunkGraphs:
    """Captured chunks: one engine's, or the process-wide cache of the
    batch driver's steps (see the module docstring), with ``max_bytes``,
    the bytes it holds at most, ``second_use``, capture at a key's second
    use, and ``group``, the process group whose ranks run this cache's
    chunks in lockstep (they evict what the largest count over the group
    evicts)."""

    def __init__(self, max_bytes: Optional[int] = None, second_use: bool = False,
                 group=None):
        self.max_bytes = max_bytes
        self.group = group
        self._seen: Optional["OrderedDict[Tuple, None]"] = (
            OrderedDict() if second_use else None)
        self._slots: Dict[Tuple, _Slot] = {}
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()

    def run_chunk(self, state, A_scan, A_full, c, candidate_mask, *,
                  pricing: int, chunk: int, opt_tol: float, pivot_tol: float,
                  degen_tol: float, stop_at_zero: bool = False,
                  noisy_scan: bool = False, shard=None):
        """``kernels.run_chunk`` as a replayed graph (``shard``: this
        rank's ``ColumnShard`` under a mesh, its collectives captured)."""
        return self.run(
            kernels.run_chunk, state,
            dict(A_scan=A_scan, A_full=A_full, c=c, candidate_mask=candidate_mask),
            must_launch="scan" if pricing == kernels.PRICE_STEEPEST else None,
            pricing=pricing, chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, stop_at_zero=stop_at_zero, noisy_scan=noisy_scan,
            shard=shard, early_exit=False,
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
                     eta0: Optional[int] = None, shard=None):
        """``lu.lu_run_chunk`` as a replayed graph: on the eta-ring
        kernels' route (``eta_ring.launches_kernel``) one for every fill of
        the ring, its key's ``eta0`` None and ``eta0`` not read; else one
        per ``eta0`` (the ring's fill at entry, read here when not given).
        ``shard`` as for ``run_chunk``."""
        kernel_route = eta_ring.launches_kernel(state.eta_vals)
        if kernel_route:
            eta0 = None
        elif eta0 is None:
            eta0 = int(state.eta_count)
        return self.run(
            lu.lu_run_chunk, state,
            dict(A_scan=A_scan, A_full=A_full, c=c, candidate_mask=candidate_mask),
            must_launch="eta_ftran" if kernel_route else None,
            pricing=pricing, chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, stop_at_zero=stop_at_zero, eta0=eta0, shard=shard,
            early_exit=False,
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
            must_launch="scan" if pricing == kernels.PRICE_STEEPEST else None,
            pricing=pricing, chunk=chunk, opt_tol=opt_tol, pivot_tol=pivot_tol,
            degen_tol=degen_tol, stop_at_zero=stop_at_zero, noisy_scan=noisy_scan,
            early_exit=False,
        )

    def captured(self, body: Callable, name: str) -> Counter:
        """{value of the static argument ``name``: captures} over this
        cache's entries of ``body`` (the LU chunk's captures by ``eta0``)."""
        return Counter(entry.static[name] for key, entry in self._entries.items()
                       if key[0] is body)

    def run(self, body: Callable, state: NamedTuple, inputs: Dict[str, torch.Tensor],
            *, must_launch: Optional[str] = None, bound: Tuple[str, ...] = (), **static):
        """``body(state, **inputs, **static)`` as a replayed graph, captured
        at the first call of its key (the second with ``second_use``; the
        first runs eagerly); ``must_launch``: the name of a counter of
        ``launch_counts`` that a capture on CUDA must have counted (it
        raises when that kernel did not launch); ``bound``: the roles of
        inputs read in place (see ``release``)."""
        global REPLAYS
        # Each input's role, or the role of the earlier input it is.
        alias = {}
        for role, x in inputs.items():
            alias[role] = next(r for r, y in inputs.items() if y is x)
        key = (body, type(state), tuple(sorted(static.items())),
               tuple(_signature(x) for x in state),
               tuple((role, alias[role], _signature(x), id(x) if role in bound else None)
                     for role, x in inputs.items()))
        entry = self._entries.get(key)
        if entry is None and self._seen is not None and key not in self._seen:
            self._seen[key] = None
            if len(self._seen) > _SEEN_LIMIT:
                self._seen.popitem(last=False)
            return body(state, **inputs, **static)
        state_keys = [(f"state.{name}", *_signature(x))
                      for name, x in zip(state._fields, state)]
        input_keys = {role: (role, *_signature(x)) for role, x in inputs.items()
                      if alias[role] == role and role not in bound}
        for slot_key, x in zip(state_keys, state):
            self._slot(slot_key, x).fill(x, always=True)
        for role, slot_key in input_keys.items():
            self._slot(slot_key, inputs[role]).fill(inputs[role], always=False)
        if entry is None:
            static_state = type(state)(*(self._slots[k].buffer for k in state_keys))
            static_inputs = {role: inputs[role] if alias[role] in bound
                             else self._slots[input_keys[alias[role]]].buffer
                             for role in inputs}
            entry = self._entries[key] = self._capture(
                body, static_state, static_inputs, static, must_launch,
                (*state_keys, *input_keys.values()),
                tuple(inputs[role] for role in bound if alias[role] == role))
            self._evict(state[0].device)
        else:
            self._entries.move_to_end(key)
        entry.graph.replay()
        REPLAYS += 1
        _set_launch_counts({name: n + entry.launches[name]
                            for name, n in launch_counts().items()})
        return tree_map(torch.clone, entry.outputs)

    def nbytes(self) -> int:
        """The bytes this cache holds: its graphs' memory pools, its static
        buffers and the tensors its entries read in place."""
        bound = {id(x): x for entry in self._entries.values() for x in entry.bound}
        return (sum(entry.pool_bytes for entry in self._entries.values())
                + sum(slot.nbytes for slot in self._slots.values())
                + sum(x.untyped_storage().nbytes() for x in bound.values()))

    def release(self, *tensors: torch.Tensor) -> None:
        """Drop every entry that reads one of ``tensors`` in place, and the
        static buffers no kept entry reads."""
        for key in [key for key, entry in self._entries.items()
                    if any(x is t for x in entry.bound for t in tensors)]:
            del self._entries[key]
        self._prune()

    def clear(self) -> None:
        """Drop every entry, every static buffer and every key seen once."""
        self._entries.clear()
        self._slots.clear()
        if self._seen is not None:
            self._seen.clear()

    def _evict(self, device: torch.device) -> None:
        global EVICTIONS
        while (self.max_bytes is not None and len(self._entries) > 1
               and self._held(device) > self.max_bytes):
            self._entries.popitem(last=False)
            EVICTIONS += 1
            self._prune()

    def _held(self, device: torch.device) -> int:
        """``nbytes()``; with a group, the largest over its ranks (a MAX
        all_reduce on the host, not counted among the solver's
        collectives): ranks hold column blocks of different widths when N
        is not a multiple of their number, and every rank must evict the
        same entries, or one would capture (its warm-up running the
        chunk's collectives) where another replays."""
        if self.group is None:
            return self.nbytes()
        held = torch.tensor([self.nbytes()], dtype=torch.int64, device=device)
        dist.all_reduce(held, op=dist.ReduceOp.MAX, group=self.group)
        return int(held)

    def _prune(self) -> None:
        used = {k for entry in self._entries.values() for k in entry.slots}
        self._slots = {k: slot for k, slot in self._slots.items() if k in used}

    def _slot(self, key: Tuple, x: torch.Tensor) -> _Slot:
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = _Slot(x)
        return slot

    def _capture(self, body, state, inputs, static, must_launch, slots, bound) -> _Entry:
        global CAPTURES, CAPTURE_SECONDS
        device = state[0].device
        counts = launch_counts()
        with trace.timed("graph.capture", tag=body.__name__) as clock:
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
                before = launch_counts()
                reserved = _reserved(device)
                # With a process group up, the capture refuses unsafe calls of
                # this thread only: ProcessGroupNCCL's watchdog thread queries
                # the CUDA events of eager collectives, which a capture in the
                # default global mode would take as its own error.
                graph.capture_begin(capture_error_mode="thread_local"
                                    if dist.is_available() and dist.is_initialized()
                                    else "global")
                try:
                    outputs = body(state, **inputs, **static)
                finally:
                    graph.capture_end()
                pool_bytes = max(0, _reserved(device) - reserved)
            if stream is not None:
                torch.cuda.current_stream(device).wait_stream(stream)
            launches = {name: n - before[name] for name, n in launch_counts().items()}
            _set_launch_counts(counts)
            if must_launch and device.type == "cuda" and not launches[must_launch]:
                raise RuntimeError(
                    f"captured a {body.__name__} that launched no {must_launch} kernel")
        CAPTURES += 1
        CAPTURE_SECONDS += clock.seconds
        return _Entry(graph, outputs, launches, static, slots, bound, pool_bytes)
