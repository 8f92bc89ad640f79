"""The port's span recorder (``relp_tpu_torch.utils.logging``) and the spans
the port records at its layer boundaries, on the CPU.

The recorder: nesting, parents, request ids and self time; the ring's
overflow; recording off; the ``gc`` hook; the mapping of the span clock
onto a ``torch.profiler`` trace by ``epoch_offset_ns``; no JAX import.  The
boundaries: a ``solve_general_form``'s spans in order, with ``chunk`` and
``chunk.exit`` alternating; ``SolveStats.certify_time_s`` and
``graphs.CAPTURE_SECONDS`` as the sums of their spans; the ``solve``
span's count of captures, none on a second solve of a shape; a ``solve_mip``'s
``bb.search`` around ``batch`` around ``certify``.  The benchmark's six
readers of the spans (``portbench/metrics``) against hand-computed values.
"""

import gc
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import Registry
from portbench.spans import Call
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.io import load_general_form
from relp_tpu_torch.simplex import graphs, solve_general_form
from relp_tpu_torch.testing import RecordingGraph
from relp_tpu_torch.utils import logging as trace
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KNAP6 = ROOT / "tests" / "data" / "knap6.mps"
SMALL = dict(platform="cpu", pad_to=8, chunk_size=2, refactor_period=2)


@pytest.fixture(autouse=True)
def empty_ring():
    """Each test starts from an empty ring with recording on, and leaves
    recording on."""
    was = trace.recording(True)
    trace.reset()
    yield
    trace.recording(was)
    trace.reset()


def _names(spans):
    return [s.name for s in spans]


def test_nesting_parents_requests_and_self_time():
    with trace.span("request") as outer:
        with trace.span("solve") as inner:
            trace.add("a", inner.start + 10, inner.start + 40)
            trace.add("b", inner.start + 30, inner.start + 60)
        trace.add("c", inner.end + 5, inner.end + 6)
    with trace.span("request"):
        pass
    trace.add("gc", 0, 1)
    got = {s.id: s for s in trace.spans()}
    first, second = [s for s in got.values() if s.name == "request"]
    solve, = [s for s in got.values() if s.name == "solve"]
    a, b, c, loose = (next(s for s in got.values() if s.name == n)
                      for n in ("a", "b", "c", "gc"))
    assert first.parent == 0 and first.id == outer.id
    assert solve.parent == first.id and a.parent == b.parent == solve.id
    assert c.parent == first.id
    assert solve.request == a.request == b.request == c.request == first.request
    assert len({first.request, second.request, loose.request}) == 3
    assert loose.parent == 0
    own = trace.self_ns(list(got.values()))
    # a and b overlap on [30, 40): their union covers 50 ns of the solve.
    assert own[solve.id] == (solve.end - solve.start) - 50
    assert own[first.id] == (first.end - first.start) - (solve.end - solve.start) - 1
    assert own[a.id] == 30 and own[loose.id] == 1


def test_the_spans_of_a_solve_in_order():
    """presolve, standardize, one solve with its lowering, placing and
    chunks, certification, reconstruction; every chunk followed by its
    exit, each carrying its pivots, which sum to the solve's."""
    result, solution = solve_general_form(load_general_form(str(KNAP6)),
                                          SolverConfig(**SMALL))
    assert solution is not None and result.stats.certified
    spans = trace.spans()
    names = _names(spans)
    assert names[:6] == ["request", "presolve", "standardize", "solve", "lower", "place"]
    assert names[-2:] == ["certify", "reconstruct"]
    loop = names[6:-2]
    assert len(loop) == 2 * result.stats.chunks > 2
    assert loop == ["chunk", "chunk.exit"] * result.stats.chunks
    request = spans[0]
    assert all(s.request == request.request for s in spans)
    solve = spans[3]
    assert solve.counts == {"pivots": result.stats.iterations, "chunks": result.stats.chunks,
                            "captures": 0}  # the CPU runs its chunks eagerly
    chunks = [s for s in spans if s.name == "chunk"]
    assert all(s.parent == solve.id for s in chunks)
    assert sum(s.counts["pivots"] for s in chunks) == result.stats.iterations
    for before, after in zip(spans[6:-3], spans[7:-2]):
        assert before.end <= after.start


def test_certify_time_is_the_sum_of_the_certify_spans():
    result, _solution = solve_general_form(load_general_form(str(KNAP6)),
                                           SolverConfig(**SMALL))
    certify = [s for s in trace.spans() if s.name == "certify"]
    assert certify
    assert result.stats.certify_time_s == sum((s.end - s.start) / 1e9 for s in certify)


def test_capture_seconds_are_the_sum_of_the_capture_spans(monkeypatch):
    """The recording stand-in for the CUDA graph, with the CPU among the
    captured devices: each capture is one graph.capture span inside its
    chunk, tagged with the body it captured."""
    monkeypatch.setattr(graphs, "Graph", RecordingGraph)
    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_CHUNKS", None)
    captures0, seconds0 = graphs.CAPTURES, graphs.CAPTURE_SECONDS
    solve_general_form(load_general_form(str(KNAP6)), SolverConfig(**SMALL))
    spans = trace.spans()
    captured = [s for s in spans if s.name == "graph.capture"]
    assert len(captured) == graphs.CAPTURES - captures0 > 0
    assert graphs.CAPTURE_SECONDS - seconds0 == pytest.approx(
        sum((s.end - s.start) / 1e9 for s in captured), rel=1e-12, abs=1e-12)
    chunk_ids = {s.id for s in spans if s.name == "chunk"}
    assert all(s.parent in chunk_ids and s.tag == "run_chunk" for s in captured)


def test_the_solve_span_counts_the_captures_of_its_attempt(monkeypatch):
    """The solve span's captures: the graph captures its attempt made, at
    least one on the first solve of a shape and none on a second solve of
    it, whose chunks replay from the process-wide cache."""
    monkeypatch.setattr(graphs, "Graph", RecordingGraph)
    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_CHUNKS", None)
    counts = []
    for _ in range(2):
        trace.reset()
        captures0 = graphs.CAPTURES
        solve_general_form(load_general_form(str(KNAP6)), SolverConfig(**SMALL))
        solve, = [s for s in trace.spans() if s.name == "solve"]
        assert solve.counts["captures"] == graphs.CAPTURES - captures0
        counts.append(solve.counts["captures"])
    assert counts[0] >= 1 and counts[1] == 0


def test_a_search_holds_its_batches_and_their_certification():
    from relp_tpu_torch.mip import solve_mip
    from relp_tpu_torch.testing import mknap

    mip = solve_mip(mknap(m=3, n=14, tightness=0.25, seed=7),
                    SolverConfig(platform="cpu", dtype="float64"),
                    batch_width=4, node_limit=12)
    assert mip.nodes_solved > 0
    spans = {s.id: s for s in trace.spans()}
    search, = [s for s in spans.values() if s.name == "bb.search"]
    batches = [s for s in spans.values() if s.name == "batch"]
    assert batches and all(b.parent == search.id for b in batches)
    inside = [s for s in spans.values() if s.name == "certify" and s.parent in
              {b.id for b in batches}]
    assert inside
    assert all(s.request == search.request for s in spans.values() if s.name != "gc")
    assert sum(b.counts["lps"] for b in batches) >= mip.nodes_solved


def test_the_ring_drops_its_oldest_and_a_reader_then_reads_nothing():
    gc.disable()  # no gc span among these
    try:
        for k in range(trace.CAPACITY + 10):
            trace.add("chunk.exit", 1000 + k, 1001 + k)
        assert trace.DROPPED == 10
        held = trace.spans()
        assert len(held) == trace.CAPACITY and held[0].start == 1010
        assert trace.window(1005, 2000) is None
        assert len(trace.window(1010, 1020)) == 10
        record = SimpleNamespace(seconds=1.0, calls=[Call("request", 1005e-9, 2000e-9,
                                                          1, 1, 1, 0.0)])
        assert Registry().reader("metrics", "chunk_exit_share.lp").read(record) is None
    finally:
        gc.enable()
    trace.reset()
    assert trace.DROPPED == 0 and trace.spans() == []


def _summary(result):
    s = result.stats
    return (result.status, result.exact_objective, result.basis, s.iterations,
            s.phase1_iterations, s.chunks, s.certified)


def test_recording_off_records_nothing_and_changes_nothing():
    gf = load_general_form(str(KNAP6))
    on, on_solution = solve_general_form(gf, SolverConfig(**SMALL))
    assert trace.spans()
    trace.reset()
    trace.recording(False)
    off, off_solution = solve_general_form(load_general_form(str(KNAP6)),
                                           SolverConfig(**SMALL))
    gc.collect(2)
    assert trace.spans() == [] and trace.DROPPED == 0
    assert _summary(off) == _summary(on)
    assert off_solution.objective_value == on_solution.objective_value
    assert off.stats.certify_time_s > 0 and off.stats.wall_time_s > 0


def test_a_span_lands_around_its_op_on_the_profiler_timeline():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(256, 256)
    offset = trace.epoch_offset_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("op") as op:
            torch.mm(a, a)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.name() == "aten::mm"]
    assert len(events) == 1
    start = events[0].start_ns() - offset
    assert op.start <= start and start + events[0].duration_ns() <= op.end


def test_a_full_collection_is_one_gc_span():
    with trace.span("request") as outer:
        gc.collect(2)
    collected = [s for s in trace.spans() if s.name == "gc"]
    assert len(collected) == 1
    assert collected[0].parent == outer.id and "collected" in collected[0].counts
    trace.reset()
    gc.collect(0)
    gc.collect(1)
    assert trace.spans() == []


def _synthetic_window():
    """A window of 10 s of two requests, with spans of every kind the
    readers read: one chunk with a capture and a collection inside it, one
    collection before the window's first call, and one span clipped by the
    window's end."""
    s = 10 ** 9
    for fields in [
        # name, start, end, id, parent, request, counts, tag
        ("gc", 0, s // 2, 1, 0, 1, {}, None),
        ("presolve", 1 * s, 2 * s, 2, 0, 2, {}, None),
        ("standardize", 2 * s, 3 * s, 3, 0, 2, {}, None),
        ("lower", 3 * s, 7 * s // 2, 4, 0, 2, {}, None),
        ("place", 7 * s // 2, 4 * s, 5, 0, 2, {}, None),
        ("chunk.exit", 5 * s, 6 * s, 6, 0, 3, {}, None),
        ("chunk", 6 * s, 7 * s, 7, 0, 3, {"pivots": 300}, None),
        ("graph.capture", 6 * s, 64 * s // 10, 8, 7, 3, {}, "run_chunk"),
        ("gc", 65 * s // 10, 66 * s // 10, 9, 7, 3, {}, None),
        ("gc", 8 * s, 33 * s // 4, 10, 0, 4, {}, None),
        ("reconstruct", 95 * s // 10, 11 * s, 11, 0, 3, {}, None),
    ]:
        trace._write(fields)
    calls = [Call("request", 1.0, 5.0, 1, 1, 10, 0.0),
             Call("request", 5.0, 10.0, 1, 1, 10, 0.0)]
    return SimpleNamespace(seconds=10.0, calls=calls)


@pytest.mark.parametrize("metric, want", [
    ("host_pipeline_share.lp", 100 * (1 + 1 + 0.5 + 0.5 + 0.5) / 10),
    ("chunk_pivots_per_s.lp", 300 / (1 - 0.4 - 0.1)),
    ("chunk_exit_share.lp", 100 * 1 / 10),
    ("gc_share.lp", 100 * (0.1 + 0.25) / 10),
    ("graph_capture_share.batched", 100 * 0.4 / 10),
    ("gc_share.batched", 100 * (0.1 + 0.25) / 10),
])
def test_each_reader_of_the_spans(metric, want):
    record = _synthetic_window()
    assert Registry().reader("metrics", metric).read(record) == pytest.approx(want, rel=1e-9)


def test_a_reader_reads_nothing_without_spans():
    record = SimpleNamespace(seconds=10.0, calls=[Call("request", 1.0, 5.0, 1, 1, 10, 0.0)])
    assert Registry().reader("metrics", "gc_share.lp").read(record) is None


SCRIPT = r"""
import json, sys

REFUSED = ("jax", "jaxlib", "relp_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused in this process: " + name)
        return None

sys.meta_path.insert(0, Refuse())
from relp_tpu_torch.utils import logging
with logging.span("request"):
    pass
print(json.dumps({"spans": [s.name for s in logging.spans()],
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in REFUSED)}))
"""


def test_the_recorder_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "spans": ["request"], "loaded": []}
