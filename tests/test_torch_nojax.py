"""relp_tpu_torch runs where neither jax nor the JAX package can be
imported (a CUDA machine with PyTorch only): a subprocess refuses every
import of jax, jaxlib and relp_tpu, imports the port, solves knap6 on the
CPU to the exact -30, and finds none of them loaded; another runs a small
scenario batch through relp_tpu_torch.parallel; a third imports every
module of the port."""

import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json, sys

REFUSED = ("jax", "jaxlib", "relp_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused in this process: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import relp_tpu_torch
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.simplex import solve_general_form
from relp_tpu_torch.io import load_general_form

result, solution = solve_general_form(
    load_general_form(sys.argv[1]), SolverConfig(platform="cpu")
)
print(json.dumps({
    "status": result.status.value,
    "objective": str(solution.objective_value),
    "certified": result.stats.certified,
    "refused_modules": sorted(m for m in sys.modules if m.split(".")[0] in REFUSED),
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
        '"refused_modules": []}'
    )


BATCH_SCRIPT = r"""
import json, sys

REFUSED = ("jax", "jaxlib", "relp_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused in this process: " + name)
        return None

sys.meta_path.insert(0, Refuse())
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
    "refused_modules": sorted(m for m in sys.modules if m.split(".")[0] in REFUSED),
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
        '{"statuses": ["finite_optimum"], "certified": true, '
        '"refused_modules": []}'
    )


ALL_MODULES_SCRIPT = r"""
import importlib, json, pkgutil, sys

REFUSED = ("jax", "jaxlib", "relp_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused in this process: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import relp_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    relp_tpu_torch.__path__, "relp_tpu_torch."))
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": len(names),
    "refused_modules": sorted(m for m in sys.modules if m.split(".")[0] in REFUSED),
}))
"""


def test_every_port_module_imports_with_relp_tpu_refused():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", ALL_MODULES_SCRIPT],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["refused_modules"] == [] and out["modules"] >= 50


SLICE_SCRIPT = r"""
import importlib, json, sys

REFUSED = ("jax", "jaxlib", "relp_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused in this process: " + name)
        return None

sys.meta_path.insert(0, Refuse())
for name in ("relp_tpu_torch.mip", "relp_tpu_torch.firstorder",
             "relp_tpu_torch.simplex.lu", "relp_tpu_torch.simplex.host_sparse"):
    importlib.import_module(name)
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.io import load_general_form
from relp_tpu_torch.mip import solve_mip

mip = solve_mip(load_general_form(sys.argv[1]), SolverConfig(platform="cpu"))
print(json.dumps({
    "objective": str(mip.objective),
    "certified": mip.certified,
    "refused_modules": sorted(m for m in sys.modules if m.split(".")[0] in REFUSED),
}))
"""


def test_mip_first_order_lu_and_host_sparse_import_with_jax_refused():
    """The modules of the MIP, first-order, LU and host-sparse paths import
    with jax, jaxlib and relp_tpu refused, and knap6 solves as a MIP."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SLICE_SCRIPT, str(ROOT / "tests" / "data" / "knap6.mps")],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == (
        '{"objective": "-30", "certified": true, "refused_modules": []}'
    )


def test_port_sources_never_import_relp_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+relp_tpu\b(?!_torch)", re.MULTILINE)
    sources = sorted((ROOT / "relp_tpu_torch").rglob("*.py"))
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())
    assert not (ROOT / "relp_tpu_torch" / "_host.py").exists()


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.MULTILINE)
    sources = sorted((ROOT / "relp_tpu_torch").rglob("*.py"))
    assert sources
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())
