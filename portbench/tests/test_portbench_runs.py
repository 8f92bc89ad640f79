"""Whole runs of the cells on the CPU at tiny sizes, with the harness's look
for a card skipped: sound runs are correct, the control (the reference in
a lower precision in the program's place) is not, nor is a run whose timed
path is broken underneath.  The family entry, which no cell uses yet, is
driven the same way."""

import json
import time

import pytest

from portbench import harness
from portbench.tests.conftest import make_registry

SEED = 2**31 + 977  # past 32 signed bits, as the benchmark's seeds may be


def run(registry, cell, **kw):
    return harness.run_cell(cell, SEED, kw.pop("seconds", 1.5), kw.pop("trace", False),
                            t_start=time.perf_counter(), registry=registry,
                            platform="cpu", **kw)


@pytest.mark.parametrize("cell", ["mknapcb9.lp-stream", "mknapcb1.bb-w16"])
def test_a_sound_run_is_correct(tiny, cell):
    out = run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    e2e = {"mknapcb9.lp-stream": "lp_s", "mknapcb1.bb-w16": "certified_lps_per_s"}[cell]
    assert out["metrics"][e2e]["value"] > 0 and out["metrics"]["setup_s"]["value"] > 0
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("cell", ["mknapcb9.lp-stream", "mknapcb1.bb-w16"])
def test_the_control_is_not_correct(tiny, cell):
    precision = tiny.cell(cell)["control"]
    out = run(tiny, cell, control=precision)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["mknapcb9.lp-stream", "mknapcb1.bb-w16"])
def test_per_layer_metrics_are_read_on_the_cpu_where_no_trace_is_needed(tiny, cell):
    out = run(tiny, cell, trace=True)
    assert out["correct"]
    names = set(out["metrics"])
    if cell == "mknapcb9.lp-stream":
        assert {"certify_share.lp", "pivots_per_s.lp", "graph_capture_share.lp"} <= names
    else:
        assert {"certify_share.batched", "batch_pivots_per_s.batched",
                "bb_host_share.batched"} <= names
    assert not any(n.startswith(("device_idle_share", "scan_roofline")) for n in names)


def _altering(monkeypatch, alter):
    """``alter(result)`` after every certification, single and batched."""
    from relp_tpu_torch.parallel import batch_driver
    from relp_tpu_torch.simplex import driver

    def altering(certify):
        def run(result, *args, **kwargs):
            certify(result, *args, **kwargs)
            if result.exact_bfs is not None:
                alter(result)
        return run

    monkeypatch.setattr(driver, "certify_and_repair", altering(driver.certify_and_repair))
    monkeypatch.setattr(batch_driver, "certify_and_repair",
                        altering(batch_driver.certify_and_repair))


def _altered_points(monkeypatch):
    """An answer altered where it is produced: every certified point's
    values doubled, its objective with them."""
    from relp_tpu_torch.linalg.sparse import SparseVector

    def alter(result):
        bfs = result.exact_bfs
        result.exact_bfs = SparseVector([(j, 2 * v) for j, v in bfs], len(bfs.to_dense()))
        result.bfs = result.exact_bfs
        result.exact_objective *= 2

    _altering(monkeypatch, alter)


def _unchanged_steps(monkeypatch):
    """Every chunk of pivots, single and batched, returns its state
    unchanged."""
    from relp_tpu_torch.parallel import batch_driver
    from relp_tpu_torch.simplex import engine

    monkeypatch.setattr(engine.DenseEngine, "run_chunk",
                        lambda self, state, *a, **k: state)
    kept = batch_driver.run_step

    def step(body, state, inputs, **kwargs):
        out = kept(body, state, inputs, **kwargs)
        if body is batch_driver._batch_step:
            return (state, *out[1:]) if isinstance(out, tuple) and not hasattr(
                out, "_fields") else state
        return out

    monkeypatch.setattr(batch_driver, "run_step", step)


def _half_the_batch(monkeypatch):
    """solve_batch returns the first half of its answers twice: the
    second half of the batch left out."""
    from relp_tpu_torch.parallel import batch_driver

    kept = batch_driver.solve_batch

    def solve(providers, *args, **kwargs):
        results = kept(providers, *args, **kwargs)
        half = (len(results) + 1) // 2
        return (results[:half] * 2)[:len(results)]

    monkeypatch.setattr(batch_driver, "solve_batch", solve)


FAULTS = {
    "mknapcb9.lp-stream": [_altered_points, _unchanged_steps],
    "mknapcb1.bb-w16": [_altered_points, _unchanged_steps, _half_the_batch],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    # An unchanged step never converges: a small iteration limit ends it.
    registry = make_registry(tmp_path)
    for name in ("mknapcb9", "mknapcb1"):
        path = tmp_path / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.setdefault("solver", {})["max_iterations"] = 400
        path.write_text(json.dumps(cfg))
    fault(monkeypatch)
    out = run(registry, cell, seconds=1.0)
    assert not out["correct"], out["checks"]


def test_the_family_entry_is_correct_and_its_control_is_not(tmp_path):
    def family(bench):
        bench["workloads"].append({"name": "mknapcb9.family", "config": "mknapcb9",
                                   "traffic": "family", "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "mknapcb1.bb-w16" in m.get("workloads", []) and m["name"] != "bb_host_share.batched":
                m["workloads"].append("mknapcb9.family")

    registry = make_registry(tmp_path, family)
    (tmp_path / "cells" / "mknapcb9.family.json").write_text(json.dumps({
        "name": "mknapcb9.family", "config": "mknapcb9", "entry": "portbench.entries.family",
        "traffic": {"family_size": 6, "sample": 6, "memory_after": 1}, "control": "tf32",
        "trace": {"start_after_share": 0.0, "seconds": 1.0}, "limits": {}}))
    out = run(registry, "mknapcb9.family")
    assert out["correct"], out["checks"]
    assert out["attempted"] % 6 == 0 and out["attempted"] >= 6
    assert out["metrics"]["certified_lps_per_s"]["value"] > 0
    out = run(registry, "mknapcb9.family", control="tf32")
    assert not out["correct"]


def test_a_configuration_cell_and_metric_are_added_as_files_alone(tmp_path):
    """A dummy configuration, cell, end-to-end metric and per-layer metric,
    each a new file in a copy of the layout, and new entries in
    BENCHMARK.json: no existing file of the benchmark changes."""
    from portbench.tests.conftest import PORTBENCH

    before = {p: p.read_bytes() for p in PORTBENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}

    def extra(bench):
        bench["configs"].append({"name": "mknap_small", "source": "test",
                                 "file": "portbench/configs/mknap_small.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": "mknap_small.lp-stream", "config": "mknap_small",
                                   "traffic": "lp-stream", "chips": 1, "why": "test"})
        bench["end_to_end"].append({"name": "requests", "unit": "LPs", "better": "higher",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": ["mknap_small.lp-stream"]})
        bench["per_layer"].append({"name": "mean_pivots.lp", "unit": "pivots",
                                   "better": "lower", "source": "program_counter",
                                   "layer": "single-LP driver and chunk loop",
                                   "moves": "lp_s", "workloads": ["mknap_small.lp-stream"]})
        for m in bench["end_to_end"]:
            if m["name"] == "lp_s":
                m["workloads"].append("mknap_small.lp-stream")

    registry = make_registry(tmp_path, extra)
    cfg = json.loads((tmp_path / "configs" / "mknapcb9.json").read_text())
    cfg.update(name="mknap_small", m=3, n=12)
    (tmp_path / "configs" / "mknap_small.json").write_text(json.dumps(cfg))
    cell = json.loads((tmp_path / "cells" / "mknapcb9.lp-stream.json").read_text())
    cell.update(name="mknap_small.lp-stream", config="mknap_small")
    (tmp_path / "cells" / "mknap_small.lp-stream.json").write_text(json.dumps(cell))
    (tmp_path / "endtoend" / "requests.py").write_text(
        "UNIT, BETTER, SOURCE = 'LPs', 'higher', 'host_clock'\n"
        "def read(record):\n"
        "    return sum(c.kind == 'request' for c in record.calls)\n")
    (tmp_path / "metrics" / "mean_pivots.lp.py").write_text(
        "LAYER, UNIT, BETTER, SOURCE, MOVES = ('single-LP driver and chunk loop', "
        "'pivots', 'lower', 'program_counter', 'lp_s')\n"
        "def read(record):\n"
        "    calls = [c for c in record.calls if c.kind == 'request']\n"
        "    return sum(c.iterations for c in calls) / len(calls) if calls else None\n")
    out = run(registry, "mknap_small.lp-stream")
    assert out["correct"]
    assert {"lp_s", "requests", "setup_s"} <= set(out["metrics"])
    out = run(registry, "mknap_small.lp-stream", trace=True)
    assert out["metrics"]["mean_pivots.lp"]["value"] > 0
    after = {p: p.read_bytes() for p in PORTBENCH.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert after == before
