"""BENCHMARK.json against the benchmark's contract and its files, and the
imports of what the benchmark runs."""

import ast
import json
import re
import subprocess
import sys

import pytest

from portbench.bounds import pivot_chunk_bound_s, scan_bound_s
from portbench.harness import REFUSED, Registry
from portbench.tests.conftest import PORTBENCH, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_the_top_level_keys_and_the_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32 and not any(
        w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


@pytest.mark.parametrize("section", sorted(KEYS))
def test_every_entry_has_the_contract_keys_and_allowed_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        allowed = KEYS[section] | ({"workloads"} if section in ("end_to_end", "per_layer")
                                   else set())
        assert KEYS[section] <= set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end":
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_metrics_bounds_and_cells_fit_together():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and NAME.match(w["config"])
        reported = [m for m in e2e.values() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_every_listed_item_has_its_file_and_the_file_agrees():
    registry = Registry()
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
    for w in BENCH["workloads"]:
        cell = registry.cell(w["name"])
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"]:
        reader = registry.reader("endtoend", m["name"])
        assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (
            m["unit"], m["better"], m["source"])
    for m in BENCH["per_layer"]:
        reader = registry.reader("metrics", m["name"])
        assert (reader.LAYER, reader.UNIT, reader.BETTER, reader.SOURCE, reader.MOVES) == (
            m["layer"], m["unit"], m["better"], m["source"], m["moves"])


def test_the_file_is_small_and_file_names_are_names():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for path in PORTBENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PORTBENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(REFUSED), (path, tops & set(REFUSED))


def test_the_reference_and_the_generators_import_nothing_of_the_program():
    for folder in ("reference", "gen"):
        for path in (PORTBENCH / folder).glob("*.py"):
            tops = {name.split(".")[0] for name in _imports(path)}
            assert tops <= {"__future__", "collections", "fractions", "typing", "numpy",
                            "portbench"}, (path, tops)
            assert not any(n.startswith(("portbench.entries", "portbench.harness"))
                           for n in _imports(path))


def test_what_a_run_loads_holds_no_jax_module():
    """Import everything a run imports, then look at sys.modules by whole
    top-level name (relp_tpu_torch begins with relp_tpu and is allowed)."""
    code = (
        "import sys, importlib\n"
        "import portbench.run, portbench.harness, portbench.trace, portbench.spans\n"
        "import portbench.problems.mknap\n"
        "for m in ('lp_stream', 'bb', 'family'):\n"
        "    importlib.import_module('portbench.entries.' + m)\n"
        "import relp_tpu_torch.mip, relp_tpu_torch.parallel, relp_tpu_torch.simplex\n"
        "from portbench.harness import Registry, refused_modules\n"
        "r = Registry()\n"
        "for m in r.benchmark['per_layer']: r.reader('metrics', m['name'])\n"
        "for m in r.benchmark['end_to_end']: r.reader('endtoend', m['name'])\n"
        "print(refused_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_outside_a_checkout_of_the_program_prints_no_result(tmp_path):
    """A folder with only BENCHMARK.json and portbench/: the program is
    missing, so the run fails and prints nothing on standard output."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "mknapcb9.lp-stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_without_a_card_exits_without_a_result():
    """This machine has no card (the test is meaningful only here)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "mknapcb9.lp-stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""


@pytest.mark.parametrize("M,N,itemsize,want_us", [
    (1920, 5248, 4, 12.06), (1024, 5120, 4, 6.29), (1920, 5248, 8, 24.13),
    (1920, 5248, 2, 6.03)])
def test_the_scan_bound_at_the_kernel_table_shapes(M, N, itemsize, want_us):
    seconds, by = scan_bound_s(M, N, itemsize)
    assert round(seconds * 1e6, 2) == want_us and by == "bytes"


def test_the_blocked_chunk_bound_at_the_kernel_table_shape():
    """128 LPs of 512 x 1408 on one tableau, a 25-pivot chunk each."""
    seconds, by = pivot_chunk_bound_s(128, 512, 1408, True, 128 * 25, 128)
    assert round(seconds * 1e6, 1) == 284.5 and by == "operations"


def test_an_idle_gap_is_labelled_by_what_filled_most_of_it():
    from portbench.spans import Call, Recorder
    from portbench.trace import _label

    recorder = Recorder()
    recorder.calls.append(Call("request", 0.0, 1.0, 1, 1, 10, 0.5))
    recorder.solves.append(Call("single", 0.1, 1.0, 1, 1, 10, 0.5))
    recorder.certify_spans.append((0.5, 1.0))
    assert _label(recorder, 0.45, 1.2) == "certification"
    assert _label(recorder, 0.15, 0.6) == "single-LP driver host"
    assert _label(recorder, 0.95, 1.6) == "between calls (branch and bound, the harness)"
    assert _label(recorder, 0.0, 0.12) == "host pipeline (presolve, standardize, lowering)"
