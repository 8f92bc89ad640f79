"""The benchmark on a card (marker ``cuda``; skipped without one):

    python -m pytest -p no:cacheprovider -m cuda portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_prints_a_correct_result(cuda_card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert line["device"]["memory_peak_bytes"] > 0 and list(line)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
