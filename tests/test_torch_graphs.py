"""Captured chunks (``relp_tpu_torch.simplex.graphs``) on the CPU.

A CUDA graph needs a card, so these tests put a recording stand-in
(``relp_tpu_torch.testing.RecordingGraph``) in place of
``torch.cuda.CUDAGraph``: between ``capture_begin`` and ``capture_end`` it
records every aten op and every collective the chunk runs, with the
tensors it reads and writes, and its ``replay`` runs them again in order
on the same tensors, each result written into the tensor the capture made,
each collective waited for.  Like a CUDA graph it fixes every tensor's
identity at capture and refuses what a capture refuses: a read of a
tensor's value on the host and a tensor made from host data.  The tests
hold:

* the key apart for every static argument, input shape and dtype;
* the inputs copied in and the outputs cloned out, so that a state the
  caller keeps survives later replays, and a changed matrix is copied in;
* the scan launches of a capture added by every replay, as eager chunks
  count them;
* a replayed chunk equal, bit for bit, to the eager chunk, primal and dual;
* ``solve_general_form`` / ``solve_relaxation`` through ``DenseEngine``
  with captured chunks giving the eager path's pivots, bases and exact
  objectives on the CPU-sized cases of tests/test_torch_driver.py;
* every unsharded engine (dense, LU, df32) taking the process-wide cache
  of chunks, so that separate solves of one shape capture each key once
  and a second call nothing, each with its eager result; the end of a
  solve trimming that cache to its bound in bytes, to no entry; a
  sharded engine and a ``pdhg_solve`` call capturing into caches of their
  own, again on every call;
* the LU chunk (steepest edge and Dantzig, entering with an empty ring and
  with etas in it, with and without phase 1's stop at zero), the df32
  chunk and the PDHG chunk (replayed with a changed Halpern counter and
  step sizes) each bitwise equal to its eager chunk; the key apart for
  the ring's fill at entry and for the body; the caller's eta ring left
  as it was;
* whole solves with ``basis_inverse="lu"`` and ``carry="df32"`` through
  captured chunks giving the eager pivots, bases and exact objectives,
  and ``pdhg_solve`` / ``solve_first_order`` the eager iterates and
  restarts;
* under a mesh (a gloo world of one): shards keyed by value, the sharded
  dense and LU chunks replayed bit for bit with the eager chunk's
  collectives counted per replay, and a cache of steps of its own for a
  mesh's column group.  tests/test_torch_mesh.py replays the sharded
  loops in 2 and 4 processes.

The card's own graphs are held to eager chunks in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.ops import price_scan
from relp_tpu_torch.firstorder import pdhg, solve_first_order
from relp_tpu_torch.simplex import (
    df_kernels,
    graphs,
    kernels,
    lu,
    solve_general_form,
    solve_relaxation,
)
from relp_tpu_torch.simplex.state import SimplexState
from relp_tpu_torch.testing import (
    BODY_KINDS,
    CHUNK_KINDS,
    RecordingGraph,
    body_case,
    chunk_case,
    lu_start,
    pdhg_lp,
    synthetic_problem,
    synthetic_start,
)
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_driver import PORT, SCAN_BF16, SIMPLEX_SMALL

@pytest.fixture
def recording(monkeypatch):
    """The stand-in as the graph type, the CPU among the captured devices,
    the module's counters from zero, and process-wide caches of the
    engines' chunks (``graphs.chunks()``) and of the batch driver's steps
    (``graphs.steps()``) that live for the test."""
    monkeypatch.setattr(graphs, "Graph", RecordingGraph)
    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
    for name, zero in (("CAPTURES", 0), ("REPLAYS", 0), ("CAPTURE_SECONDS", 0.0),
                       ("EVICTIONS", 0), ("_CHUNKS", None), ("_STEPS", None),
                       ("_GROUP_STEPS", {})):
        monkeypatch.setattr(graphs, name, zero)


@pytest.fixture
def counting(monkeypatch):
    """The scan counted on the CPU as the wrapper counts its launches on a
    card (the plain version computes the result)."""
    def scan(P, A, c, gamma, gamma_q):
        price_scan.LAUNCHES += 1
        price_scan.LAUNCHES_BY_DTYPE[str(A.dtype).replace("torch.", "")] += 1
        return price_scan.fused_price_scan_reference(P, A, c, gamma, gamma_q)

    monkeypatch.setattr(kernels, "fused_price_scan", scan)
    monkeypatch.setattr(df_kernels, "fused_price_scan", scan)
    monkeypatch.setattr(price_scan, "LAUNCHES", 0)
    monkeypatch.setattr(price_scan, "LAUNCHES_BY_DTYPE",
                        dict.fromkeys(price_scan.LAUNCHES_BY_DTYPE, 0))


def _start(m=24, n=40, pad=8, dtype=np.float64, seed=3):
    """(state, A, c1, c2, mask) of testing.synthetic_problem at its
    artificial start (phase-1 costs), on the CPU."""
    return synthetic_start(m=m, n=n, pad=pad, dtype=dtype, seed=seed)


def _dual_start(state):
    """The state with its basic values negated: the dual chunk pivots."""
    return state._replace(xB=-state.xB)


PRIMAL = dict(pricing=kernels.PRICE_STEEPEST, chunk=12, opt_tol=1e-9, pivot_tol=1e-9,
              degen_tol=1e-9)
DUAL = dict(chunk=12, opt_tol=1e-9, pivot_tol=1e-9, feas_tol=1e-9)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).view(torch.uint8) if x.dtype != torch.bool else x


def _assert_bitwise(got, want):
    """Every field of two NamedTuples of tensors bitwise equal."""
    assert type(got) is type(want)
    for name, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(_bits(g), _bits(w)), name


def test_key_separates_static_arguments_shapes_and_dtypes(recording):
    state, A, c1, _c2, mask = _start()
    cache = graphs.ChunkGraphs()

    def captures(run, *args, **kw):
        before = graphs.CAPTURES
        run(*args, **kw)
        return graphs.CAPTURES - before

    primal = lambda st, A_scan, **kw: cache.run_chunk(  # noqa: E731
        st, A_scan, A, c1, mask, **dict(PRIMAL, **kw))
    assert captures(primal, state, A) == 1
    assert captures(primal, state, A) == 0  # the same key again
    for change in (dict(pricing=kernels.PRICE_DANTZIG), dict(chunk=5),
                   dict(opt_tol=1e-8), dict(pivot_tol=1e-8), dict(degen_tol=1e-8),
                   dict(stop_at_zero=True), dict(noisy_scan=True)):
        assert captures(primal, state, A, **change) == 1, change
    # A_scan a copy of A_full (not the same tensor), in the same and in a
    # lower dtype.
    assert captures(primal, state, A.clone()) == 1
    assert captures(primal, state._replace(d=state.d.float()), A.float()) == 1
    # Another shape, another working dtype.
    st2, A2, c12, _c22, mask2 = _start(m=16, n=40)
    assert captures(cache.run_chunk, st2, A2, A2, c12, mask2, **PRIMAL) == 1
    st3, A3, c13, _c23, mask3 = _start(dtype=np.float32)
    assert captures(cache.run_chunk, st3, A3, A3, c13, mask3, **PRIMAL) == 1
    dual = lambda **kw: cache.dual_run_chunk(  # noqa: E731
        _dual_start(state), A, A, c1, mask, **dict(DUAL, **kw))
    assert captures(dual) == 1 and captures(dual) == 0
    for change in (dict(chunk=5), dict(opt_tol=1e-8), dict(pivot_tol=1e-8),
                   dict(feas_tol=1e-8), dict(noisy_scan=True)):
        assert captures(dual, **change) == 1, change
    assert graphs.REPLAYS == 20


@pytest.mark.parametrize("stop_at_zero", [False, True])
def test_replayed_primal_chunks_equal_eager_chunks(recording, stop_at_zero):
    """Chunk after chunk from the phase-1 start (each replay from the last
    one's output), the eager chunk's bits, also with the scans on a lower-
    precision copy of the tableau."""
    state, A, c1, _c2, mask = _start()
    for A_scan, st in ((A, state), (A.float(), state._replace(d=state.d.float()))):
        cache, graphed, eager = graphs.ChunkGraphs(), st, st
        kw = dict(PRIMAL, stop_at_zero=stop_at_zero)
        for _ in range(4):
            graphed = cache.run_chunk(graphed, A_scan, A, c1, mask, **kw)
            eager = kernels.run_chunk(eager, A_scan, A, c1, mask, **kw)
            _assert_bitwise(graphed, eager)
        assert int(eager.iteration) > 12


def test_replayed_dual_chunks_equal_eager_chunks(recording):
    state, A, c1, _c2, mask = _start()
    cache, graphed = graphs.ChunkGraphs(), _dual_start(state)
    eager = graphed
    for _ in range(3):
        graphed = cache.dual_run_chunk(graphed, A, A, c1, mask, **DUAL)
        eager = kernels.dual_run_chunk(eager, A, A, c1, mask, **DUAL)
        _assert_bitwise(graphed, eager)
    assert int(eager.iteration) > 0


@pytest.mark.parametrize("kind", CHUNK_KINDS)
def test_each_kind_of_chunk_replays_the_eager_bits(recording, kind):
    """The kinds of chunk that chip_smoke's chunk/graph line and the card's
    tests compare (testing.chunk_case), from an f32 start."""
    state, A, c1, _c2, mask = synthetic_start(m=20, n=36, pad=8, dtype=np.float32, seed=7)
    name, args, kw = chunk_case(kind, state, A, c1, mask, chunk=15)
    eager = getattr(kernels, name)(*args, **kw)
    _assert_bitwise(getattr(graphs.ChunkGraphs(), name)(*args, **kw), eager)
    assert int(eager.iteration) > 0


def test_inputs_copied_in_and_outputs_cloned_out(recording):
    """A kept output survives the next replay; each call computes from its
    own state, c and mask (a tensor changed in place is copied in again)."""
    state, A, c1, c2, mask = _start()
    cache = graphs.ChunkGraphs()
    first = cache.run_chunk(state, A, A, c1, mask, **PRIMAL)
    kept = SimplexState(*(x.clone() for x in first))
    second = cache.run_chunk(first, A, A, c1, mask, **PRIMAL)
    _assert_bitwise(first, kept)
    assert all(g.data_ptr() != f.data_ptr() for g, f in zip(second, first))
    # From the same entry state again (the driver's rollback), and with the
    # phase-2 costs: one graph, the inputs of each call.
    again = cache.run_chunk(state, A, A, c1, mask, **PRIMAL)
    _assert_bitwise(again, first)
    for c in (c2, c1):
        _assert_bitwise(cache.run_chunk(first, A, A, c, mask, **PRIMAL),
                        kernels.run_chunk(first, A, A, c, mask, **PRIMAL))
    c1.mul_(2.0)
    _assert_bitwise(cache.run_chunk(first, A, A, c1, mask, **PRIMAL),
                    kernels.run_chunk(first, A, A, c1, mask, **PRIMAL))
    fewer = mask.clone()
    fewer[: A.shape[1] // 2] = False
    _assert_bitwise(cache.run_chunk(state, A, A, c1, fewer, **PRIMAL),
                    kernels.run_chunk(state, A, A, c1, fewer, **PRIMAL))
    assert graphs.CAPTURES == 1


def test_replays_add_the_captured_scan_launches(recording, counting):
    """Each replay adds what its capture counted: the eager chunk's count
    (early_exit=False runs every iteration, as on a card); the warm-up's
    and the capture's own counts are taken back."""
    state, A, c1, _c2, mask = _start()
    cache = graphs.ChunkGraphs()
    for replays in (1, 2, 3):
        cache.run_chunk(state, A, A, c1, mask, **PRIMAL)
        assert price_scan.LAUNCHES == 12 * replays
        assert price_scan.LAUNCHES_BY_DTYPE["float64"] == 12 * replays
    cache.run_chunk(state._replace(d=state.d.float()), A.float(), A, c1, mask, **PRIMAL)
    assert price_scan.LAUNCHES_BY_DTYPE == {"float32": 12, "float64": 36, "bfloat16": 0}
    kernels.run_chunk(state, A, A, c1, mask, early_exit=False, **PRIMAL)
    assert price_scan.LAUNCHES == 60
    cache.run_chunk(state, A, A, c1, mask, **dict(PRIMAL, pricing=kernels.PRICE_DANTZIG))
    assert price_scan.LAUNCHES == 60


def test_a_capture_refuses_host_reads(recording):
    """The stand-in refuses what a CUDA graph capture refuses: the eager
    body's CPU-only early exit reads the status on the host."""
    state, A, c1, _c2, mask = _start()
    graph = RecordingGraph()
    graph.capture_begin()
    try:
        with pytest.raises(RuntimeError, match="inside a capture"):
            kernels.run_chunk(state, A, A, c1, mask, early_exit=True, **PRIMAL)
        with pytest.raises(RuntimeError, match="inside a capture"):
            torch.tensor(1e-9)
    finally:
        graph.capture_end()


def _solve_summary(result):
    return (result.status.value, result.stats.certified, result.exact_objective,
            result.basis, result.stats.iterations, result.stats.phase1_iterations,
            result.stats.dual_iterations, result.stats.chunks)


@pytest.mark.parametrize("dtype", ["float32", "float64", SCAN_BF16])
@pytest.mark.parametrize("name", sorted(SIMPLEX_SMALL))
def test_solves_through_captured_chunks_match_eager(monkeypatch, name, dtype):
    """solve_general_form with DenseEngine's chunks captured (the stand-in)
    and eager: the same verdict, exact objective, basis, pivots and chunks."""
    build, overrides = SIMPLEX_SMALL[name]
    if dtype == SCAN_BF16:
        overrides, dtype = dict(overrides, scan_dtype="bfloat16"), "float32"
    cfg = SolverConfig(dtype=dtype, platform="cpu", **overrides)
    eager, _solution = solve_general_form(build(PORT), cfg)
    with monkeypatch.context() as patched:
        patched.setattr(graphs, "Graph", RecordingGraph)
        patched.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
        patched.setattr(graphs, "REPLAYS", 0)
        patched.setattr(graphs, "_CHUNKS", None)
        captured, _solution = solve_general_form(build(PORT), cfg)
        replays = graphs.REPLAYS
    assert _solve_summary(captured) == _solve_summary(eager)
    assert replays == captured.stats.chunks


def test_warm_dual_restart_through_captured_chunks_matches_eager(monkeypatch):
    """The dual restart of tests/test_torch_driver.py (a changed right-hand
    side, warm-started from the old optimum) through captured dual chunks."""

    def provider(b2):
        gf = PORT.gf(PORT.O.MINIMIZE, [[1, 2], [3, 1]], [PORT.R.less(), PORT.R.less()],
                     [4, b2], [-1, -1], [(0, None), (0, None)])
        return gf.derive_matrix_data(gf.standardize())

    cfg = SolverConfig(pad_to=8, platform="cpu")
    basis = solve_relaxation(provider(6), cfg).basis
    dual_pivots = 0
    for b2 in (3, 1, 14):
        eager = solve_relaxation(provider(b2), cfg, warm_start_basis=basis)
        with monkeypatch.context() as patched:
            patched.setattr(graphs, "Graph", RecordingGraph)
            patched.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
            patched.setattr(graphs, "_CHUNKS", None)
            captured = solve_relaxation(provider(b2), cfg, warm_start_basis=basis)
        assert _solve_summary(captured) == _solve_summary(eager)
        dual_pivots += captured.stats.dual_iterations
    assert dual_pivots > 0


def test_the_engine_captures_only_on_a_captured_device_without_a_mesh(recording,
                                                                     monkeypatch):
    """Without a mesh, DenseEngine, LUEngine and DoubleFloatEngine take the
    process-wide cache (graphs.chunks()) on a device in DEVICE_TYPES, every
    engine the same one; a device outside it runs eagerly.  A shard: the
    next tests."""
    from relp_tpu_torch.simplex.engine import DenseEngine, DoubleFloatEngine, LUEngine

    state = _start()[0]
    engines = (DenseEngine, LUEngine, DoubleFloatEngine)
    for engine_cls in engines:
        engine = engine_cls(torch.device("cpu"))
        assert engine._chunk_graphs(state) is graphs.chunks()
        assert engine._chunk_graphs(state) is graphs.chunks()
    assert graphs.chunks().max_bytes == graphs.STEP_CACHE_BYTES
    assert graphs.chunks()._seen is None and graphs.chunks() is not graphs.steps()
    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda",))
    for engine_cls in engines:
        assert engine_cls(torch.device("cpu"))._chunk_graphs(state) is None


def test_a_sharded_engine_captures_on_a_captured_device_too(recording, monkeypatch):
    """With a shard (a mesh's chunks are captured with their collectives),
    DenseEngine and LUEngine keep one cache for their life on a device in
    DEVICE_TYPES, as without one; a device outside it runs eagerly."""
    from relp_tpu_torch.simplex.engine import DenseEngine, LUEngine

    state = _start()[0]
    for engine_cls in (DenseEngine, LUEngine):
        engine = engine_cls(torch.device("cpu"), shard=object())
        cache = engine._chunk_graphs(state)
        assert isinstance(cache, graphs.ChunkGraphs) and engine._chunk_graphs(state) is cache
    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda",))
    for engine_cls in (DenseEngine, LUEngine):
        assert engine_cls(torch.device("cpu"), shard=object())._chunk_graphs(state) is None


def test_a_sharded_engine_gets_a_cache_of_its_own(recording):
    """A sharded engine's cache is its own: neither the process-wide cache
    of chunks nor another sharded engine's, unbounded, capturing at a key's
    first use (every rank of a mesh would have to agree on each eviction of
    a cache that outlives a solve)."""
    from relp_tpu_torch.simplex.engine import DenseEngine, LUEngine

    state = _start()[0]
    caches = [engine_cls(torch.device("cpu"), shard=object())._chunk_graphs(state)
              for engine_cls in (DenseEngine, DenseEngine, LUEngine)]
    assert len({id(cache) for cache in caches}) == 3
    assert all(cache.max_bytes is None and cache._seen is None and cache.group is None
               for cache in caches)
    assert graphs._CHUNKS is None  # never made


@pytest.mark.parametrize("kind", ["sharded", "pdhg"])
def test_a_sharded_solve_and_a_pdhg_call_capture_into_caches_of_their_own(recording,
                                                                         kind):
    """A solve on a sharded engine (a gloo world of one) and a pdhg_solve
    call each capture into a cache of their own that goes with them: a
    second call of the same problem gives the same result and captures as
    many again, and the process-wide cache of chunks is never made."""
    from relp_tpu_torch.testing import scenario_family
    from tests.test_torch_mesh import world_of_one

    def call():
        if kind == "pdhg":
            A, b, c, u = pdhg_lp(16, 40, 11)
            x, y, st = pdhg.pdhg_solve(A, b, c, u, tol=1e-7, max_iters=600, chunk=100,
                                       dtype=np.float64, device="cpu")
            return x.tobytes(), y.tobytes(), st.iterations, st.restarts
        with world_of_one() as mesh:
            return _solve_summary(solve_relaxation(
                scenario_family(12, 30, 7, 1)[0], SolverConfig(platform="cpu", pad_to=8),
                mesh=mesh))

    first = call()
    captures = graphs.CAPTURES
    assert call() == first and graphs.CAPTURES == 2 * captures > 0
    assert graphs._CHUNKS is None


SOLVE_MODES = {"dense": {}, "lu": dict(basis_inverse="lu"), "df32": dict(carry="df32")}


@pytest.mark.parametrize("mode", sorted(SOLVE_MODES))
def test_a_shared_cache_serves_the_solves_of_one_shape(recording, monkeypatch, mode):
    """Every unsharded engine takes the process-wide cache of chunks
    (graphs.chunks()): separate solves of LPs of one shape (a stream's
    requests, a MIP's single solves, solve_batch's single-LP fallbacks)
    capture each key once, the first call all of them and a second call
    none, and each solve gives its eager verdict, basis, pivots and exact
    objective (its own A, b and c copied in)."""
    from relp_tpu_torch.testing import scenario_family

    cfg = SolverConfig(dtype="float32", platform="cpu", pad_to=8, **SOLVE_MODES[mode])
    providers = scenario_family(12, 30, 7, 3)
    with monkeypatch.context() as eager_chunks:
        eager_chunks.setattr(graphs, "DEVICE_TYPES", ("cuda",))
        eager = [_solve_summary(solve_relaxation(p, cfg)) for p in providers]
    for call in range(2):
        captures = graphs.CAPTURES
        assert [_solve_summary(solve_relaxation(p, cfg)) for p in providers] == eager
        if call == 0:
            assert graphs.CAPTURES == len(graphs.chunks()._entries) > 0
        else:
            assert graphs.CAPTURES == captures
    assert graphs.REPLAYS == 2 * sum(summary[-1] for summary in eager)
    assert graphs.EVICTIONS == 0


def test_the_end_of_a_solve_trims_the_process_cache_to_its_bound(recording,
                                                               monkeypatch):
    """At the end of every solve the process-wide cache of chunks evicts
    its least recently used entries down to its bound in bytes, to no
    entry if need be: with a bound that holds one shape's graphs and
    buffers, a solve of another shape before it leaves nothing behind and
    the last shape's entries stay; with a bound below one LP's, nothing of
    the solve stays.  Every solve gives its eager result."""
    from relp_tpu_torch.testing import scenario_family

    cfg = SolverConfig(platform="cpu", pad_to=8)
    small, large = scenario_family(12, 30, 7, 1)[0], scenario_family(20, 44, 5, 1)[0]
    with monkeypatch.context() as eager_chunks:
        eager_chunks.setattr(graphs, "DEVICE_TYPES", ("cuda",))
        eager = {p: _solve_summary(solve_relaxation(p, cfg)) for p in (small, large)}

    def solve(provider, bound):
        graphs.chunks().max_bytes = bound
        assert _solve_summary(solve_relaxation(provider, cfg)) == eager[provider]

    solve(large, None)
    cache = graphs.chunks()
    keys, held = set(cache._entries), cache.nbytes()
    assert keys and held > 0
    graphs._CHUNKS = None
    solve(small, held)
    solve(large, held)
    cache = graphs.chunks()
    assert set(cache._entries) == keys and cache.nbytes() == held
    assert graphs.EVICTIONS > 0
    solve(small, 1)
    assert not cache._entries and not cache._slots and cache.nbytes() == 0


@pytest.mark.parametrize("kind", BODY_KINDS)
def test_each_body_replays_the_eager_bits(recording, kind):
    """The LU, df32 and PDHG chunks of testing.body_case (chip_smoke's
    chunk/graph line and the card's tests compare the same kinds)."""
    start, eager, graphed = body_case(kind, 20, 36, pad=8, chunk=15)
    want = eager(start)
    _assert_bitwise(graphed(graphs.ChunkGraphs(), start), want)
    if kind != "pdhg":
        assert int(want.iteration) > int(start.iteration)


LU_KW = dict(chunk=6, opt_tol=1e-9, pivot_tol=1e-9, degen_tol=1e-9)


@pytest.mark.parametrize("stop_at_zero", [False, True])
@pytest.mark.parametrize("pricing", [kernels.PRICE_STEEPEST, kernels.PRICE_DANTZIG])
def test_replayed_lu_chunks_equal_eager_chunks(recording, pricing, stop_at_zero):
    """LU chunk after LU chunk from the phase-1 start, each replay from the
    last one's output: the first enters with an empty ring, the later ones
    with 6, 12 and 18 etas in a ring of 20 (the last fills it), each a
    capture of its own; every output the eager chunk's bits."""
    state, A, c1, _c2, mask = lu_start(m=24, n=40, pad=8, seed=3, capacity=20)
    cache, graphed, eager = graphs.ChunkGraphs(), state, state
    kw = dict(LU_KW, pricing=pricing, stop_at_zero=stop_at_zero)
    entries = []
    for _ in range(4):
        entries.append(int(eager.eta_count))
        graphed = cache.lu_run_chunk(graphed, A, A, c1, mask, **kw)
        eager = lu.lu_run_chunk(eager, A, A, c1, mask, **kw)
        _assert_bitwise(graphed, eager)
    assert int(eager.iteration) > 6 and len(set(entries)) > 1
    assert cache.captured(lu.lu_run_chunk, "eta0") == dict.fromkeys(entries, 1)
    assert graphs.CAPTURES == len(set(entries))


def test_lu_key_separates_eta0_and_the_body(recording):
    """The ring's fill at entry is part of the LU chunk's key, as are the
    body and the state's type; eta0 given or read from the state is one
    key."""
    state, A, c1, _c2, mask = lu_start(m=24, n=40, pad=8, seed=3, capacity=20)
    cache = graphs.ChunkGraphs()
    kw = dict(LU_KW, pricing=kernels.PRICE_STEEPEST)

    def captures(run, *args, **more):
        before = graphs.CAPTURES
        run(*args, **dict(kw, **more))
        return graphs.CAPTURES - before

    after = lu.lu_run_chunk(state, A, A, c1, mask, **dict(kw, chunk=3))
    assert captures(cache.lu_run_chunk, state, A, A, c1, mask) == 1
    assert captures(cache.lu_run_chunk, state, A, A, c1, mask, eta0=0) == 0
    assert captures(cache.lu_run_chunk, after, A, A, c1, mask) == 1
    assert captures(cache.lu_run_chunk, after, A, A, c1, mask, eta0=3) == 0
    assert captures(cache.lu_run_chunk, state, A, A, c1, mask, stop_at_zero=True) == 1
    assert cache.captured(lu.lu_run_chunk, "eta0") == {0: 2, 3: 1}
    # The dense chunk at the same shapes is another body and state type.
    dense, A_d, c1_d, _c2_d, mask_d = synthetic_start(m=24, n=40, pad=8, seed=3,
                                                      dtype=np.float32)
    assert captures(cache.run_chunk, dense, A_d, A_d, c1_d, mask_d) == 1
    assert cache.captured(kernels.run_chunk, "pricing") == {kernels.PRICE_STEEPEST: 1}


def test_a_replayed_lu_chunk_leaves_the_callers_ring_unchanged(recording):
    """The chunk writes its etas into its own clone of the static ring: the
    caller's state (a chunk entry the driver may roll back to) keeps every
    bit, also after later replays, and the output is a tensor of its own."""
    state, A, c1, _c2, mask = lu_start(m=24, n=40, pad=8, seed=3, capacity=20)
    state = lu.lu_run_chunk(state, A, A, c1, mask, pricing=kernels.PRICE_STEEPEST,
                            **dict(LU_KW, chunk=2))
    kept = lu.LUState(*(x.clone() for x in state))
    cache = graphs.ChunkGraphs()
    kw = dict(LU_KW, pricing=kernels.PRICE_STEEPEST)
    first = cache.lu_run_chunk(state, A, A, c1, mask, **kw)
    cache.lu_run_chunk(first, A, A, c1, mask, **kw)
    cache.lu_run_chunk(state, A, A, c1, mask, **kw)
    _assert_bitwise(state, kept)
    assert int(first.eta_count) == int(state.eta_count) + 6
    assert not torch.equal(first.eta_vals, state.eta_vals)
    assert first.eta_vals.data_ptr() != state.eta_vals.data_ptr()


@pytest.mark.parametrize("stop_at_zero", [False, True])
def test_replayed_df32_chunks_equal_eager_chunks(recording, counting, stop_at_zero):
    """df32 chunk after df32 chunk, each replay from the last one's output:
    the eager bits, and the scan launches of the eager chunks counted."""
    start, _eager, _graphed = body_case("df32", 24, 40, pad=8, seed=3)
    A64, _b, c64, _c2, cand, _basis = synthetic_problem(m=24, n=40, pad=8, seed=3)
    from relp_tpu_torch.ops.df32 import df_from_f64

    (Ah, Al), (ch, cl) = df_from_f64(A64), df_from_f64(c64)
    args = (Ah, Ah, Al, ch, cl, torch.as_tensor(cand))
    kw = dict(pricing=kernels.PRICE_STEEPEST, chunk=6, opt_tol=1e-9, pivot_tol=1e-9,
              degen_tol=1e-9, stop_at_zero=stop_at_zero)
    cache, graphed, eager = graphs.ChunkGraphs(), start, start
    for _ in range(3):
        graphed = cache.df_run_chunk(graphed, *args, **kw)
        launches = price_scan.LAUNCHES
        eager = df_kernels.df_run_chunk(eager, *args, early_exit=False, **kw)
        assert price_scan.LAUNCHES - launches == 6
        _assert_bitwise(graphed, eager)
    assert price_scan.LAUNCHES == 2 * 18
    assert int(eager.iteration) > 6 and graphs.CAPTURES == 1


def test_replayed_pdhg_chunks_follow_changed_k0_tau_and_sigma(recording):
    """One graph serves every chunk of a PDHG solve: the Halpern counter,
    the step sizes and the anchor are copied in with the iterate, so a
    replay with other values gives the eager chunk's bits."""
    As, bs, cs, us, _dr, _dc = pdhg.scale_problem(*pdhg_lp(12, 30, 5), np.float32)
    A, b, c, u = (torch.as_tensor(v) for v in (As, bs, cs, us))
    inputs = dict(A=A, b=b, c=c, u=u)
    cache = graphs.ChunkGraphs()
    x, y = torch.zeros_like(c), torch.zeros_like(b)
    ax, ay = x, y
    for k0, tau, sigma in ((0.0, 0.3, 0.3), (20.0, 0.3, 0.3), (40.0, 0.15, 0.6),
                           (0.0, 0.6, 0.15)):
        carry = pdhg.pdhg_carry(x, y, ax, ay, k0, tau, sigma)
        graphed = cache.run(pdhg._pdhg_chunk, carry, inputs, chunk=20)
        eager = pdhg._pdhg_chunk(carry, **inputs, chunk=20)
        _assert_bitwise(graphed, eager)
        x, y = graphed.x, graphed.y
        if k0 == 40.0:
            ax, ay = graphed.x_t, graphed.y_t
    assert graphs.CAPTURES == 1 and graphs.REPLAYS == 4
    assert float(torch.linalg.vector_norm(x)) > 0.0


def _captured_solve(monkeypatch, solve):
    """``solve()`` with the engines' chunks captured (the stand-in) into an
    empty process-wide cache, and the replays it made."""
    with monkeypatch.context() as patched:
        patched.setattr(graphs, "Graph", RecordingGraph)
        patched.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
        patched.setattr(graphs, "REPLAYS", 0)
        patched.setattr(graphs, "_CHUNKS", None)
        result = solve()
        return result, graphs.REPLAYS


@pytest.mark.parametrize("mode", ["lu", "df32"])
@pytest.mark.parametrize("name", sorted(SIMPLEX_SMALL))
def test_lu_and_df32_solves_through_captured_chunks_match_eager(monkeypatch, name, mode):
    """solve_general_form with basis_inverse="lu" (f32) and carry="df32"
    with captured chunks and eager: the same verdict, exact objective,
    basis, pivots and chunks, every chunk a replay."""
    build, overrides = SIMPLEX_SMALL[name]
    mode_cfg = dict(basis_inverse="lu") if mode == "lu" else dict(carry="df32")
    cfg = SolverConfig(dtype="float32", platform="cpu", **overrides, **mode_cfg)
    eager, _solution = solve_general_form(build(PORT), cfg)
    (captured, _solution), replays = _captured_solve(
        monkeypatch, lambda: solve_general_form(build(PORT), cfg))
    assert _solve_summary(captured) == _solve_summary(eager)
    assert replays == captured.stats.chunks


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pdhg_solve_through_captured_chunks_matches_eager(monkeypatch, dtype):
    """pdhg_solve with its chunks captured: the eager iterates, bit for bit,
    the same iterations, restarts and residuals; one capture a call."""
    A, b, c, u = pdhg_lp(16, 40, 11)
    kw = dict(tol=1e-7, max_iters=6_000, chunk=100, dtype=dtype, device="cpu")
    xe, ye, se = pdhg.pdhg_solve(A, b, c, u, **kw)
    monkeypatch.setattr(graphs, "CAPTURES", 0)
    (xg, yg, sg), replays = _captured_solve(
        monkeypatch, lambda: pdhg.pdhg_solve(A, b, c, u, **kw))
    assert np.array_equal(xg, xe) and np.array_equal(yg, ye)
    assert (sg.iterations, sg.restarts, sg.converged, sg.primal_residual,
            sg.dual_residual, sg.gap) == (se.iterations, se.restarts, se.converged,
                                          se.primal_residual, se.dual_residual, se.gap)
    assert se.restarts > 0 and replays == se.iterations // 100
    assert graphs.CAPTURES == 1


def test_solve_first_order_through_captured_chunks_matches_eager(monkeypatch):
    """solve_first_order (PDHG, crossover, the exact finish) with every
    chunk captured, PDHG's and the finish's: the eager verdict, objective,
    basis and pivots, and the eager PDHG statistics."""
    gf = SIMPLEX_SMALL["degenerate_lp"][0](PORT)
    md = gf.derive_matrix_data(gf.standardize())
    cfg = SolverConfig(platform="cpu", pad_to=8)
    eager = solve_first_order(md, cfg, max_iters=2_000)
    captured, replays = _captured_solve(
        monkeypatch, lambda: solve_first_order(md, cfg, max_iters=2_000))
    assert _solve_summary(captured) == _solve_summary(eager)
    assert vars(captured.first_order_stats) | {"wall_time_s": 0} == (
        vars(eager.first_order_stats) | {"wall_time_s": 0})
    assert replays == eager.first_order_stats.iterations // 200 + captured.stats.chunks


def test_equal_shards_make_one_key(recording):
    """A ColumnShard is a static argument of a captured chunk, keyed by
    value (group, size, rank, N, device): two shards of one split are one
    key, so a new call's new shard replays the graphs of the last; another
    split is another key."""
    from relp_tpu_torch.parallel.sharded import ColumnShard

    one, same = ColumnShard(None, 2, 0, 40, "cpu"), ColumnShard(None, 2, 0, 40, "cpu")
    assert one == same and hash(one) == hash(same) and one is not same
    assert len({one, same, ColumnShard(None, 2, 1, 40, "cpu"),
                ColumnShard(None, 2, 0, 41, "cpu")}) == 3
    assert one != object()
    state, A, c1, _c2, mask = _start()
    cache = graphs.ChunkGraphs()

    def body(state, A, *, shard, chunk):
        return state._replace(xB=state.xB + A[0, : state.xB.shape[0]] * shard.size)

    for shard in (one, same):
        cache.run(body, state, dict(A=A), shard=shard, chunk=1)
    assert graphs.CAPTURES == 1 and graphs.REPLAYS == 2
    cache.run(body, state, dict(A=A), shard=ColumnShard(None, 2, 1, 40, "cpu"), chunk=1)
    assert graphs.CAPTURES == 2


@pytest.mark.parametrize("engine", ["dense", "lu"])
def test_replayed_sharded_chunks_add_their_captured_collectives(recording, engine):
    """A chunk column-sharded over a gloo world of one, replayed through
    the stand-in (its collectives recorded and run again, each waited
    for), chunk after chunk: the eager sharded chunk's bits (fixed length),
    and the collectives it counts, per replay, the eager chunk's (the
    warm-up's and the capture's own taken back), as launch_counts reads
    them."""
    from relp_tpu_torch.parallel import column_shard, shard_problem, shard_state, sharded
    from tests.test_torch_mesh import world_of_one

    if engine == "lu":
        state, A, c1, _c2, mask = lu_start(m=24, n=40, pad=8, seed=3, capacity=20)
        eager_body, name, kw = lu.lu_run_chunk, "lu_run_chunk", LU_KW
    else:
        state, A, c1, _c2, mask = _start()
        eager_body, name, kw = kernels.run_chunk, "run_chunk", PRIMAL
    kw = dict(kw, pricing=kernels.PRICE_STEEPEST)
    with world_of_one() as mesh:
        shard = column_shard(mesh, A.shape[1], "cpu")
        A_s, _b, c_s, mask_s = shard_problem(mesh, A, None, c1, mask)
        eager = graphed = shard_state(mesh, state, A.shape[1])
        cache = graphs.ChunkGraphs()
        for _ in range(3):
            before = graphs.launch_counts()
            eager = eager_body(eager, A_s, A_s, c_s, mask_s, shard=shard, early_exit=False,
                               **kw)
            middle = graphs.launch_counts()
            graphed = getattr(cache, name)(graphed, A_s, A_s, c_s, mask_s, shard=shard,
                                           **kw)
            after = graphs.launch_counts()
            assert after["collectives"] - middle["collectives"] == \
                middle["collectives"] - before["collectives"] == 2 * kw["chunk"]
            assert after["collectives"] == sharded.COLLECTIVES
            _assert_bitwise(graphed, eager)
    assert int(eager.iteration) > 0 and graphs.CAPTURES == (3 if engine == "lu" else 1)


def test_a_mesh_groups_steps_have_a_cache_of_their_own(recording):
    """graphs.steps(group): one cache for each column group, apart from the
    unsharded steps', bounded and captured at a key's second use alike;
    in a world of one its agreed byte count is its own."""
    from tests.test_torch_mesh import world_of_one

    with world_of_one() as mesh:
        group = mesh.get_group("col")
        cache = graphs.steps(group)
        assert graphs.steps(group) is cache and cache is not graphs.steps()
        assert cache.group is group and graphs.steps().group is None
        assert cache.max_bytes == graphs.STEP_CACHE_BYTES and cache._seen is not None
        state, A, c1, _c2, mask = _start()
        for _ in range(2):
            cache.run_chunk(state, A, A, c1, mask, **PRIMAL)
        assert graphs.CAPTURES == 1 and cache._held(A.device) == cache.nbytes() > 0


def test_a_groups_step_cache_goes_with_release_group_and_shutdown(recording):
    """graphs.release_group(group) drops that group's cache of steps, its
    graphs and buffers, and keeps the unsharded steps' cache; shutting the
    world down (parallel.shutdown_multihost) drops every group's before
    it destroys the process groups."""
    from tests.test_torch_mesh import world_of_one

    state, A, c1, _c2, mask = _start()
    with world_of_one() as mesh:
        group = mesh.get_group("col")
        cache = graphs.steps(group)
        for _ in range(2):
            cache.run_chunk(state, A, A, c1, mask, **PRIMAL)
        unsharded = graphs.steps()
        assert graphs.CAPTURES == 1 and cache.nbytes() > 0
        graphs.release_group(group)
        assert graphs._GROUP_STEPS == {} and cache._entries == {} and cache.nbytes() == 0
        assert graphs.steps() is unsharded and graphs.steps(group) is not cache
        assert group in graphs._GROUP_STEPS
    assert graphs._GROUP_STEPS == {}
