"""relp_tpu_torch runs where jax cannot be imported (a CUDA machine with
PyTorch only): a subprocess refuses every jax import, imports the port,
solves knap6 on the CPU to the exact -30, and finds no jax module loaded;
another runs a small scenario batch through relp_tpu_torch.parallel."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json, sys

class RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is refused in this process: " + name)
        return None

sys.meta_path.insert(0, RefuseJax())
import relp_tpu_torch
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.simplex import solve_general_form
from relp_tpu_torch._host import load_general_form

result, solution = solve_general_form(
    load_general_form(sys.argv[1]), SolverConfig(platform="cpu")
)
print(json.dumps({
    "status": result.status.value,
    "objective": str(solution.objective_value),
    "certified": result.stats.certified,
    "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")),
}))
"""


def test_port_solves_knap6_with_jax_refused():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(ROOT / "tests" / "data" / "knap6.mps")],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip().splitlines()[-1]
    assert out == (
        '{"status": "finite_optimum", "objective": "-30", "certified": true, '
        '"jax_modules": []}'
    )


BATCH_SCRIPT = r"""
import json, sys

class RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is refused in this process: " + name)
        return None

sys.meta_path.insert(0, RefuseJax())
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.parallel import solve_batch
from relp_tpu_torch.testing import scenario_family

results = solve_batch(
    scenario_family(8, 24, 7, 3),
    SolverConfig(platform="cpu", pad_to=128, chunk_size=150,
                 refactor_period=150),
    certify=True, shared_structure=True,
)
print(json.dumps({
    "statuses": sorted({r.status.value for r in results}),
    "certified": all(r.stats.certified for r in results),
    "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")),
}))
"""


def test_port_solves_a_batch_with_jax_refused():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", BATCH_SCRIPT],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == (
        '{"statuses": ["finite_optimum"], "certified": true, "jax_modules": []}'
    )


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.MULTILINE)
    sources = sorted((ROOT / "relp_tpu_torch").rglob("*.py"))
    assert sources
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())
