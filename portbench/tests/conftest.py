"""Fixtures of the benchmark's tests (``python -m pytest -p no:cacheprovider
portbench/tests`` from the root of a checkout; ``-m cuda`` on a card for the
card's tests).

``tiny`` is a registry in a temporary folder: the benchmark's own files,
with the configurations cut to sizes the CPU solves in well under a second
an LP, and a BENCHMARK.json that lists them.  It imports no JAX.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
ROOT = PORTBENCH.parent

# Small enough for the CPU; large enough that the relaxations' optima are
# fractional, so that a float answer is not exact by luck.
TINY = {
    "mknapcb9": dict(m=4, n=24),
    "mknapcb1": dict(m=3, n=14, node_limit=24),
}
TINY_TRAFFIC = {
    "mknapcb9.lp-stream": dict(sample=6),
    "mknapcb1.bb-w16": dict(batch_width=4, warmup_searches=1, sample=12),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the test runs share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_registry(tmp: Path, extra_benchmark=None):
    """A copy of the benchmark's files in ``tmp`` at the tiny sizes."""
    from portbench.harness import Registry

    for kind in ("metrics", "endtoend", "cells", "configs"):
        shutil.copytree(PORTBENCH / kind, tmp / kind)
    for name, sizes in TINY.items():
        path = tmp / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(sizes)
        path.write_text(json.dumps(cfg))
    for name, traffic in TINY_TRAFFIC.items():
        path = tmp / "cells" / f"{name}.json"
        cell = json.loads(path.read_text())
        cell["traffic"].update(traffic)
        path.write_text(json.dumps(cell))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if extra_benchmark:
        extra_benchmark(bench)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(tmp, tmp / "BENCHMARK.json")


@pytest.fixture
def tiny(tmp_path):
    return make_registry(tmp_path)


@pytest.fixture
def cuda_card():
    """Skip without a card; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
