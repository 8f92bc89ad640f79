"""The batch driver's captured steps (``graphs.steps()``,
``batch_driver.run_step``) on the CPU.

A CUDA graph needs a card, so these tests use the recording stand-in of
tests/test_torch_graphs.py (its ``recording`` fixture: the stand-in as the
graph type, the CPU among the captured devices, the counters from zero and
a process-wide cache of steps for the test).  The stand-in refuses a host
read inside a capture, so the captured bodies here are the fixed-length
loops (``early_exit=False``) that a card runs.  The tests hold:

* ``_batch_step`` replayed step after step, on the batched torch path (f32
  and f64, with and without the stop at zero) and on the kernel route
  (resident and blocked shapes, the kernels' plain version on the CPU),
  equal bit for bit to the eager step, state and report; so the dual chunk
  of a warm restart and the polish chunk;
* a key run eagerly at its first use and captured at its second;
* the key apart for every static argument, the batch width, the dtype and
  the tableau's layout (one tableau expanded with batch stride 0, or B
  stacked copies), and the expanded tableau one (M, N) slice in its slot;
* B stacked tableaus read in place, not copied, and released with the
  entries that read them, by ``release`` and at the end of
  ``solve_batch``;
* the cache bounded by bytes (pools, static buffers, tensors read in
  place): the least recently used entry evicted with the input buffers no
  other entry reads;
* the batched-pivot kernels' launches counted per replay, as eager steps
  count them (the warm-up's and the capture's own taken back);
* ``solve_batch`` through captured steps equal to eager ``solve_batch``
  (statuses, exact objectives, bases, pivots) and to the JAX package's,
  on every case of tests/test_torch_batch.py::test_solve_batch_matches_jax
  (the warm family's restart among them) and on a mixed-precision family,
  a call after one of the same shape replaying its steps; two calls of one
  shape capture each key once.

The card's own graphs are held to eager steps in tests/test_torch_cuda.py.
"""

import pytest
import torch

from relp_tpu.parallel.batch_driver import solve_batch as jax_solve_batch
from relp_tpu.simplex.driver import solve_relaxation as jax_solve_relaxation
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.ops import batch_pivot
from relp_tpu_torch.parallel import batch as tb
from relp_tpu_torch.parallel import batch_driver, solve_batch
from relp_tpu_torch.parallel.batch_driver import _batch_step, run_step
from relp_tpu_torch.simplex import graphs, solve_relaxation
from relp_tpu_torch.simplex.kernels import PRICE_STEEPEST
from relp_tpu_torch.simplex.state import RUNNING
from relp_tpu_torch.testing import WARM_FAMILY, scenario_family, step_case
from tests.test_torch_batch import (  # noqa: F401  (one_torch_thread: autouse)
    JAX,
    PORT,
    _cases,
    _cfg,
    _same_results,
    _warm_family_base,
    one_torch_thread,
)
from tests.test_torch_graphs import (  # noqa: F401  (recording: a fixture)
    RecordingGraph,
    _assert_bitwise,
    _bits,
    recording,
)

def _assert_step_bitwise(got, want):
    (state_g, report_g), (state_w, report_w) = got, want
    _assert_bitwise(state_g, state_w)
    assert torch.equal(_bits(report_g), _bits(report_w))


def _steps_equal(body, state, inputs, static, steps=3):
    """``steps`` steps replayed (each from the last one's output) against
    eager ones, after one first use of the key (eager): bitwise equal;
    returns the eager pivots taken."""
    run_step(body, state, inputs, graphed=True, **static)
    graphed = eager = state
    for _ in range(steps):
        g = run_step(body, graphed, inputs, graphed=True, **static)
        e = run_step(body, eager, inputs, graphed=False, **static)
        if body is _batch_step:
            _assert_step_bitwise(g, e)
            g, e = g[0], e[0]
        else:
            _assert_bitwise(g, e)
        graphed, eager = g, e
        if body is tb.batched_run_chunk:  # the polish: every LP running again
            graphed = graphed._replace(status=torch.full_like(graphed.status, RUNNING))
            eager = eager._replace(status=torch.full_like(eager.status, RUNNING))
    return int((eager.iteration - state.iteration).sum())


# Small families of testing.scenario_family: lowered 4 x 128x256 (the
# resident kernel's shape), 3 x 256x512 (the blocked kernel's) and the warm
# family's first 4 scenarios (4 x 128x384).
SMALL = dict(m=16, n=48, seed=7, count=4)
BLOCKED = dict(m=40, n=100, seed=7, count=3)
WARM = dict(WARM_FAMILY, count=4)
STEP_CASES = [(kind, family, stop_at_zero)
              for kind, family in (("kernel", SMALL), ("kernel", BLOCKED),
                                   ("torch_float32", SMALL), ("torch_float64", SMALL))
              for stop_at_zero in (True, False)] + [("dual", WARM, None),
                                                    ("polish", SMALL, None)]


@pytest.mark.parametrize(
    "kind,family,stop_at_zero", STEP_CASES,
    ids=[f"{k}-{f['m']}x{f['n']}-{s}" for k, f, s in STEP_CASES])
def test_replayed_steps_equal_eager_steps(recording, kind, family, stop_at_zero):
    """Each kind of testing.step_case, step after step from the last one's
    output: the kernel route (the kernels' plain version on the CPU) at the
    resident and the blocked kernel's shapes, the batched torch path in f32
    and in f64 (f32 scans on a cast of the tableau), with and without the
    stop at zero; the warm restart's dual chunk; the f64 polish chunk."""
    kw = {} if stop_at_zero is None else dict(stop_at_zero=stop_at_zero)
    body, state, inputs, static = step_case(kind, family, chunk=10 if kind == "dual"
                                            else 25, **kw)
    if kind == "kernel":
        variant = "resident" if family is SMALL else "blocked"
        assert static["must_launch"] == variant
        assert tb._megakernel_variant(inputs["A"].shape) == variant
    assert inputs.get("A", inputs.get("A_full")).stride(0) == 0
    assert (inputs["A_scan"].dtype == torch.float32) == (kind != "polish")
    captures = graphs.CAPTURES  # the dual start's base solve captures its own
    assert _steps_equal(body, state, inputs, static) > 0
    # The polish chunk enters with phase 2's f32 reduced costs and leaves
    # them at f64: a chunk from its output is another key, run eagerly at
    # the second step and captured at the third.
    assert graphs.CAPTURES == captures + (2 if kind == "polish" else 1)


def test_a_key_is_captured_at_its_second_use(recording):
    """The cache of steps runs a key eagerly the first time (no buffer, no
    graph: a one-off step costs an eager step) and captures it the second;
    an engine's cache captures at the first use."""
    body, st, inputs, static = step_case("torch_float32", SMALL, chunk=5)
    steps = graphs.steps()
    first = run_step(body, st, inputs, graphed=True, **static)
    assert graphs.CAPTURES == graphs.REPLAYS == 0
    assert not steps._entries and not steps._slots
    _assert_step_bitwise(first, body(st, **inputs, **static))
    second = run_step(body, st, inputs, graphed=True, **static)
    assert (graphs.CAPTURES, graphs.REPLAYS) == (1, 1) and len(steps._entries) == 1
    _assert_step_bitwise(second, first)
    run_step(body, st, inputs, graphed=True, **static)
    assert (graphs.CAPTURES, graphs.REPLAYS) == (1, 2)
    graphs.ChunkGraphs().run(body, st, inputs, early_exit=False, **static)
    assert graphs.CAPTURES == 2


def test_key_separates_static_arguments_width_dtype_and_layout(recording):
    body, st, inputs, static = step_case("torch_float32", SMALL, chunk=5)
    cache = graphs.steps()
    assert graphs.steps() is cache and cache.max_bytes == graphs.STEP_CACHE_BYTES

    def captures(state, inputs, **change):  # over a key's first two uses
        before = graphs.CAPTURES
        for _ in range(2):
            run_step(body, state, inputs, graphed=True, **dict(static, **change))
        return graphs.CAPTURES - before

    assert captures(st, inputs) == 1
    assert captures(st, inputs) == 0
    for change in (dict(stop_at_zero=False), dict(hi_scan=True), dict(mega=True),
                   dict(chunk=6), dict(opt_tol=1e-8), dict(refactor_period=3),
                   dict(newton_steps=3), dict(use_steepest=False)):
        assert captures(st, inputs, **change) == 1, change
    # B stacked copies of the tableau: another layout of A, another key.
    A = inputs["A"]
    stacked = A.contiguous()
    assert captures(st, dict(inputs, A_scan=stacked, A=stacked)) == 1
    # Another batch width and another dtype.
    _body, st3, inputs3, _static = step_case("torch_float32", dict(SMALL, count=3))
    assert captures(st3, inputs3) == 1
    _body, st6, inputs6, _static = step_case("torch_float64", SMALL)
    assert captures(st6, inputs6) == 1
    # The same tableau as A_scan and as A, or a copy of it as A_scan.
    assert captures(st, dict(inputs, A_scan=A[0].clone().expand(A.shape))) == 1
    assert len(cache._entries) == 13 and graphs.EVICTIONS == 0


def _slots_of(cache, role):
    return [slot for key, slot in cache._slots.items() if key[0] == role]


def test_a_shared_tableau_stays_one_slice_in_its_slot(recording):
    """The expanded tableau's static buffer is one (M, N) slice expanded
    with batch stride 0; a changed tableau is copied in."""
    body, st, inputs, static = step_case("torch_float32", SMALL, chunk=5)
    A = inputs["A"]
    B, M, N = A.shape
    for _ in range(2):
        run_step(body, st, inputs, graphed=True, **static)
    (slot,) = _slots_of(graphs.steps(), "A_scan")  # A_scan is A: one slot
    assert slot.buffer.stride() == (0, N, 1) and slot.buffer.shape == A.shape
    assert slot.buffer.untyped_storage().nbytes() == M * N * A.element_size()
    assert slot.nbytes == M * N * A.element_size()
    assert torch.equal(slot.buffer, A)
    # Another tableau of the same layout: copied into the one slice.
    other = (A[0] * 2.0).expand(A.shape)
    changed = dict(inputs, A_scan=other, A=other)
    got = run_step(body, st, changed, graphed=True, **static)
    _assert_step_bitwise(got, body(st, **changed, **static))
    assert slot.buffer.stride() == (0, N, 1) and torch.equal(slot.buffer, other)


def test_stacked_tableaus_are_read_in_place_and_released(recording):
    """B stacked copies of the tableau get no static buffer: the graph
    reads the caller's tensor, the key tells two such tensors apart, the
    cache counts the tensor's bytes, and ``release`` drops the entries that
    read it with the buffers only they used."""
    body, st, inputs, static = step_case("torch_float32", SMALL, chunk=5)
    steps = graphs.steps()
    stacked = inputs["A"].contiguous()
    call = dict(inputs, A_scan=stacked, A=stacked)
    for _ in range(2):
        run_step(body, st, call, graphed=True, **static)
    assert graphs.CAPTURES == 1 and not _slots_of(steps, "A_scan")
    (entry,) = steps._entries.values()
    assert len(entry.bound) == 1 and entry.bound[0] is stacked
    slot_bytes = sum(slot.nbytes for slot in steps._slots.values())
    assert steps.nbytes() == slot_bytes + stacked.untyped_storage().nbytes()
    # Changed in place, the tableau is read as it is now.
    stacked.mul_(2.0)
    got = run_step(body, st, call, graphed=True, **static)
    _assert_step_bitwise(got, body(st, **call, **static))
    # Another stacked tensor of the same values: another key.
    twin = stacked.clone()
    for _ in range(2):
        run_step(body, st, dict(inputs, A_scan=twin, A=twin), graphed=True, **static)
    assert graphs.CAPTURES == 2 and len(steps._entries) == 2
    steps.release(stacked)
    (entry,) = steps._entries.values()
    assert entry.bound[0] is twin and steps._slots
    steps.release(twin)
    assert not steps._entries and not steps._slots and steps.nbytes() == 0


def test_solve_batch_releases_its_stacked_tableau(recording):
    """solve_batch with a tableau per LP (the default layout) replays its
    steps on the tableau in place and leaves the cache holding nothing of
    it: no entry, no static buffer."""
    cfg = SolverConfig(platform="cpu", pad_to=128, chunk_size=20, refactor_period=20)
    results = solve_batch(scenario_family(16, 48, 7, 4), cfg, certify=True)
    assert graphs.REPLAYS > 0 and graphs.CAPTURES > 0
    assert all(r.stats.certified for r in results)
    steps = graphs.steps()
    assert not steps._entries and not steps._slots and steps.nbytes() == 0


def test_the_bounded_cache_evicts_the_least_recently_used_entry(recording):
    """Past its bytes the cache drops the entry used longest ago, and the
    input buffers only that entry read; a key used again is kept."""
    cases = {count: step_case("torch_float32", dict(SMALL, count=count), chunk=3)
             for count in (4, 3, 2)}
    alone = {}
    for count, (body, st, inputs, static) in cases.items():
        one = graphs.ChunkGraphs()
        one.run(body, st, inputs, early_exit=False, **static)
        alone[count] = one.nbytes()
    cache = graphs.ChunkGraphs(max_bytes=alone[4] + alone[3])

    def run(count):
        body, st, inputs, static = cases[count]
        before = graphs.CAPTURES
        cache.run(body, st, inputs, early_exit=False, **static)
        return graphs.CAPTURES - before

    widths = lambda: sorted(  # noqa: E731  (batch widths of the kept entries)
        entry.slots[0][1][0] for entry in cache._entries.values())
    graphs.CAPTURES = graphs.EVICTIONS = 0
    assert (run(4), run(3)) == (1, 1) and widths() == [3, 4]
    assert cache.nbytes() == alone[4] + alone[3]
    assert run(4) == 0  # used again: now the most recent
    assert run(2) == 1 and graphs.EVICTIONS == 1 and widths() == [2, 4]
    assert not any(key[1][0] == 3 for key in cache._slots if key[1])
    assert cache.nbytes() == alone[4] + alone[2]
    assert run(4) == 0 and run(3) == 1 and graphs.EVICTIONS == 2
    assert widths() == [3, 4] and len(cache._entries) == 2


def test_an_entry_counts_its_graph_pool(recording, monkeypatch):
    """An entry's bytes are its memory pool, what the card's reserved
    memory grew by over the capture; a pool past the bound evicts every
    older entry but the newest."""
    reserved = iter(range(0, 10**9, 1000))
    monkeypatch.setattr(graphs, "_reserved", lambda device: next(reserved))
    body, st, inputs, static = step_case("torch_float32", SMALL, chunk=3)
    cache = graphs.ChunkGraphs()
    cache.run(body, st, inputs, early_exit=False, **static)
    (entry,) = cache._entries.values()
    slot_bytes = sum(slot.nbytes for slot in cache._slots.values())
    assert entry.pool_bytes == 1000 and cache.nbytes() == slot_bytes + 1000
    small = graphs.ChunkGraphs(max_bytes=slot_bytes + 1500)
    graphs.EVICTIONS = 0
    for chunk in (3, 4):
        small.run(body, st, inputs, early_exit=False, **dict(static, chunk=chunk))
    assert graphs.EVICTIONS == 1 and len(small._entries) == 1
    assert next(iter(small._entries.values())).static["chunk"] == 4


def test_replays_add_the_batched_pivot_launches(recording, monkeypatch):
    """Each replay of a kernel-route step adds the one launch its capture
    counted, as an eager step counts it; the warm-up's and the capture's
    launches are taken back."""
    def counted(*args, **kwargs):
        batch_pivot.LAUNCHES_RESIDENT += 1
        return batch_pivot.batched_pivot_chunk_reference(*args, **kwargs)

    monkeypatch.setattr(batch_pivot, "batched_pivot_chunk", counted)
    monkeypatch.setattr(batch_pivot, "LAUNCHES_RESIDENT", 0)
    monkeypatch.setattr(batch_pivot, "LAUNCHES_BLOCKED", 0)
    body, st, inputs, static = step_case("kernel", SMALL, chunk=10)
    graphed = st
    for replays in (1, 2, 3):
        graphed = run_step(body, graphed, inputs, graphed=True, **static)[0]
        assert batch_pivot.LAUNCHES_RESIDENT == replays
    eager = st
    for _ in range(3):
        eager = run_step(body, eager, inputs, graphed=False, **static)[0]
    assert batch_pivot.LAUNCHES_RESIDENT == 6 and batch_pivot.LAUNCHES_BLOCKED == 0
    assert graphs.CAPTURES == 1
    counts = graphs.launch_counts()
    assert (counts["resident"], counts["blocked"], counts["scan"]) == (6, 0, 0)


def _mixed_cases():
    """test_solve_batch_matches_jax's cases and a mixed-precision family
    (f64 working dtype, f32 scans: phase 2 on the f32 tableau, then the
    polish chunk at f64)."""
    cases = dict(_cases())
    scen = cases["scenarios"][0]
    cases["mixed_precision"] = (scen, dict(dtype="float64", scan_dtype="float32"), {})
    return cases


# Each case at its own chunk size, and with one-pivot chunks, which give
# every phase several chunks: a call then replays steps of its own, as it
# must with a tableau per LP, whose steps go when the call returns.
CHUNKS = ("config", "one-pivot")


def _call(case, jax=False, chunks="config"):
    """(providers, config, keywords) of a case for one package."""
    make, cfg_kw, call_kw = _mixed_cases()[case]
    if chunks == "one-pivot":
        cfg_kw = dict(cfg_kw, chunk_size=1)
    call_kw = dict(call_kw)
    warm = call_kw.pop("warm", None)
    if warm is not None:
        base = {"dual": lambda p: p.dual_provider([4, 6]),
                "interval": lambda p: p.interval_provider(1),
                "generated": _warm_family_base}[warm]
        solve = jax_solve_relaxation if jax else solve_relaxation
        call_kw["warm_start_basis"] = solve(base(JAX if jax else PORT), _cfg(jax)).basis
    return make(JAX if jax else PORT), _cfg(jax, **cfg_kw), call_kw


def _solve(case, jax=False, chunks="config"):
    providers, cfg, call_kw = _call(case, jax, chunks)
    results = (jax_solve_batch if jax else solve_batch)(providers, cfg, certify=True,
                                                        **call_kw)
    if not jax:  # nothing of a call's stacked tableau stays in the cache
        assert not any(entry.bound for entry in graphs.steps()._entries.values())
    return results


def _replays_expected(case, chunks):
    """Whether a call after one of the same case replays steps: a shared
    tableau's steps stay in the cache, a stacked one's replay only within
    a call, which one-pivot chunks make take several chunks a phase."""
    return chunks == "one-pivot" or _mixed_cases()[case][2].get("shared_structure")


def _summary(results):
    return [(r.status.value, r.exact_objective, r.stats.certified, r.basis,
             r.stats.iterations, r.stats.phase1_iterations, r.stats.dual_iterations,
             r.stats.batch_fallback) for r in results]


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("case", list(_mixed_cases()))
def test_solve_batch_through_captured_steps_matches_eager(recording, monkeypatch, case,
                                                          chunks):
    """solve_batch through the cache of steps (the stand-in), twice (the
    second call replaying the steps the first one took, where they stay in
    the cache), against the same call with every step eager
    (graphs.DEVICE_TYPES without the CPU): the same statuses, exact
    objectives, bases and pivots, every LP certified."""
    with monkeypatch.context() as eager_steps:
        eager_steps.setattr(graphs, "DEVICE_TYPES", ("cuda",))
        eager = _solve(case, chunks=chunks)
    first = _solve(case, chunks=chunks)
    replays = graphs.REPLAYS
    graphed = _solve(case, chunks=chunks)
    assert _summary(first) == _summary(graphed) == _summary(eager)
    assert all(r.stats.certified for r in graphed)
    if _replays_expected(case, chunks):
        assert graphs.REPLAYS > replays


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("case", list(_mixed_cases()))
def test_solve_batch_through_captured_steps_matches_jax(recording, case, chunks):
    """The same calls against the JAX package's solve_batch on the CPU (at
    the same chunk size), to tests/test_torch_batch.py's standard: the
    same statuses, exact objectives, certification, bases and pivots, for
    the first call and for a second one."""
    rj = _solve(case, jax=True, chunks=chunks)
    _same_results(rj, _solve(case, chunks=chunks))
    replays = graphs.REPLAYS
    _same_results(rj, _solve(case, chunks=chunks))
    if _replays_expected(case, chunks):
        assert graphs.REPLAYS > replays


def test_two_calls_of_one_shape_capture_once(recording):
    """A second solve_batch call of the same shape (a MIP's next node wave)
    replays the first call's graphs and captures only the keys the first
    call used once: over both, every key is captured once; a third call
    captures nothing."""
    cfg = SolverConfig(platform="cpu", pad_to=128, chunk_size=20, refactor_period=20)
    first = solve_batch(scenario_family(16, 48, 7, 4), cfg, certify=True,
                        shared_structure=True)
    captures, replays = graphs.CAPTURES, graphs.REPLAYS
    assert 0 < captures <= replays
    second = solve_batch(scenario_family(16, 48, 9, 4), cfg, certify=True,
                         shared_structure=True)
    assert graphs.REPLAYS > replays
    assert graphs.CAPTURES == len(graphs.steps()._entries) and graphs.EVICTIONS == 0
    captures = graphs.CAPTURES
    third = solve_batch(scenario_family(16, 48, 11, 4), cfg, certify=True,
                        shared_structure=True)
    assert graphs.CAPTURES == captures
    assert all(r.stats.certified for r in first + second + third)
    assert {r.exact_objective for r in second} != {r.exact_objective for r in first}


def test_only_a_captured_device_without_a_mesh_replays(recording, monkeypatch):
    """Without a mesh, run_step replays only when asked, and solve_batch
    asks on a device in graphs.DEVICE_TYPES: the CPU outside the tests runs
    every step eagerly.  A mesh: the next test."""
    calls = []
    kept = batch_driver.run_step

    def spy(body, state, inputs, *, graphed, **kw):
        calls.append(graphed)
        return kept(body, state, inputs, graphed=graphed, **kw)

    monkeypatch.setattr(batch_driver, "run_step", spy)
    providers = [PORT.parallel_provider(b2) for b2 in (6, 7)]
    solve_batch(providers, _cfg(False, chunk_size=1))
    assert calls and all(calls) and graphs.CAPTURES > 0
    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda",))
    calls.clear()
    before = graphs.CAPTURES
    solve_batch(providers, _cfg(False))
    assert calls and not any(calls) and graphs.CAPTURES == before


def test_a_captured_device_replays_under_a_mesh_too(recording, monkeypatch):
    """Under a mesh (a gloo world of one here) solve_batch asks run_step to
    replay on a device in graphs.DEVICE_TYPES as it does without one, its
    steps in the cache of the mesh's column group, not the unsharded
    steps' cache; on a device outside DEVICE_TYPES it runs every step
    eagerly."""
    from tests.test_torch_mesh import world_of_one

    calls = []
    kept = batch_driver.run_step

    def spy(body, state, inputs, *, graphed, **kw):
        calls.append(graphed)
        return kept(body, state, inputs, graphed=graphed, **kw)

    monkeypatch.setattr(batch_driver, "run_step", spy)
    providers = [PORT.parallel_provider(b2) for b2 in (6, 7)]
    with world_of_one() as mesh:
        solve_batch(providers, _cfg(False, chunk_size=1), mesh=mesh)
        assert graphs.steps(mesh.get_group("col"))._seen
        assert calls and all(calls) and graphs.CAPTURES > 0
        assert graphs._STEPS is None  # the unsharded steps' cache never made
        monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda",))
        calls.clear()
        before = graphs.CAPTURES
        solve_batch(providers, _cfg(False), mesh=mesh)
        assert calls and not any(calls) and graphs.CAPTURES == before
