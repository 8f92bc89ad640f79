"""The port's mesh sharding over ``torch.distributed`` (gloo, on the CPU).

One launch of 2 and one of 4 worker processes (spawned as
tests/test_multihost.py spawns them, one torch thread each, a hard 120 s
timeout on every process) runs every case and writes its findings as JSON;
each case below is a test of its own that reads them, beside the unsharded
port and the JAX package computed here:

* a column-sharded chunk in f64, every pricing rule: the unsharded port's
  (q, r) sequence pivot by pivot, and after one chunk its state within
  1e-12 relative;
* ``solve_relaxation(mesh=(1,2)/(1,4))`` on tests/test_parallel.py's
  ``_provider(6)`` and on knap6: the status, Fraction objective and basis
  of the unsharded port and of ``relp_tpu``;
* ``solve_batch`` over (2,2) (and (2,1)) on scenarios 6-9, and on three
  scenarios that the batch axis does not divide: the unsharded statuses,
  objectives, bases and iterations;
* ``pdhg_solve(mesh=(2,2))`` on tests/test_firstorder.py's 13x37 LP:
  converged, objective and primal residual within 1e-6;
* ``solve_mip(mesh=(1,2))`` on knap6: -30, on either engine;
* ties across ranks: the lowest global index wins, a NaN wins;
* a mesh shape that does not hold the world raises ``ValueError``;
* the LU engine (``basis_inverse="lu"``): its sharded chunk in f64, every
  pricing rule, walks the unsharded LU chunk's (q, r) sequence, its state
  within 1e-12 relative, on the LP and on [A, A] (every key tied across
  ranks); its ``solve_relaxation(mesh=...)`` on ``_provider(6)`` and knap6
  gives the unsharded port's verdict and ``relp_tpu``'s LU engine's over
  an 8-device mesh, with a full and a bfloat16 scan.

A world of one runs in this process (gloo), on either engine, and equals
the unsharded port.
"""

import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from relp_tpu.config import SolverConfig as JaxConfig
from relp_tpu.io import load_general_form as jax_load_general_form
from relp_tpu.simplex import solve_relaxation as jax_solve_relaxation
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.firstorder.pdhg import pdhg_solve
from relp_tpu_torch.io import load_general_form
from relp_tpu_torch.parallel import solve_batch
from relp_tpu_torch.simplex import solve_relaxation
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_firstorder import _random_lp
from tests.test_torch_host_copy import twin

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
CPU = dict(pad_to=8, chunk_size=50, refactor_period=50)  # conftest cpu_config
TIMEOUT_S = 120

WORKER = r"""
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import torch.distributed as dist

rank, world, port, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from relp_tpu_torch.parallel import (
    column_shard, initialize_multihost, make_mesh, shard_problem, shard_state,
    sharded_run_chunk,
)
initialize_multihost(f"localhost:{port}", world, rank, platform="cpu")

from relp_tpu_torch import testing
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.firstorder.pdhg import pdhg_solve
from relp_tpu_torch.io import load_general_form
from relp_tpu_torch.mip import solve_mip
from relp_tpu_torch.parallel import solve_batch
from relp_tpu_torch.simplex import kernels, solve_relaxation
from relp_tpu_torch.simplex import lu as lu_mod
from relp_tpu_torch.simplex.engine import DenseEngine, LUEngine
from relp_tpu_torch.simplex.lowering import lower_provider
from relp_tpu_torch.simplex.state import RUNNING
from tests.test_torch_host_copy import twin

parallel = twin("tests.test_parallel")
CPU = dict(platform="cpu", pad_to=8, chunk_size=50, refactor_period=50)
KNAP6 = os.path.join("tests", "data", "knap6.mps")
out = {}


def _random_lp():
    # tests/test_firstorder.py's 13x37 LP (the workers import no jax)
    rng = np.random.default_rng(7)
    m, n = 13, 37
    A = np.abs(rng.standard_normal((m, n))) + 0.1
    b = A @ np.abs(rng.standard_normal(n))
    c = rng.standard_normal(n)
    u = np.full(n, np.inf)
    u[::3] = np.abs(rng.standard_normal((n + 2) // 3)) + 1.0
    return A, b, c, u


def knap6_md():
    gf = load_general_form(KNAP6)
    gf.presolve()
    return gf.derive_matrix_data(gf.standardize())


def verdict(r):
    return [r.status.value, str(r.exact_objective), r.basis, r.stats.iterations,
            bool(r.stats.certified)]


def chunk_case():
    gf = testing.generated_lp(24, 64, 7)
    gf.presolve()
    problem = lower_provider(gf.derive_matrix_data(gf.standardize()),
                             dtype=np.float64, pad_to=8)
    cfg = SolverConfig(platform="cpu", dtype="float64", pad_to=8)
    engine = DenseEngine(torch.device("cpu"))
    A = torch.as_tensor(problem.A)
    b = torch.as_tensor(problem.b)
    c = torch.as_tensor(problem.c_phase1)
    mask = torch.as_tensor(problem.candidate_mask)
    mesh = make_mesh((1, world))
    shard = column_shard(mesh, problem.N, "cpu")
    A_s, _, c_s, mask_s = shard_problem(mesh, A, b, c, mask)
    result = {}
    for pricing in range(5):
        kw = dict(pricing=pricing, opt_tol=1e-9, pivot_tol=1e-9, degen_tol=1e-9,
                  stop_at_zero=True)
        start = engine.init_state(problem, cfg)
        if pricing == kernels.PRICE_STEEPEST:
            start = start._replace(gamma=kernels.recompute_gamma(start.Binv, A, start.in_basis))
        # A resume point past the middle: the rotation must use global ids.
        start = start._replace(price_start=torch.tensor(problem.N // 2 + 1, dtype=torch.int32))
        seqs = []
        for sharded in (False, True):
            s = shard_state(mesh, start, problem.N) if sharded else start
            seq = []
            for _ in range(40):
                before = s.basis.clone()
                if sharded:
                    s = sharded_run_chunk(shard, s, A_s, A_s, c_s, mask_s, chunk=1, **kw)
                else:
                    s = kernels.run_chunk(s, A, A, c, mask, chunk=1, **kw)
                r = torch.nonzero(s.basis != before).flatten()
                if r.numel():
                    seq.append([int(s.basis[r[0]]), int(r[0])])
                if int(s.status) != RUNNING or float(s.obj) <= 1e-9:
                    break
            seqs.append(seq)
        # One whole chunk each way, then the state, gathered, side by side.
        plain = kernels.run_chunk(start, A, A, c, mask, chunk=40, **kw)
        sh = sharded_run_chunk(shard, shard_state(mesh, start, problem.N),
                               A_s, A_s, c_s, mask_s, chunk=40, **kw)
        worst = 0.0
        for name in ("Binv", "xB", "pi", "obj", "gamma", "d"):
            p, q = getattr(plain, name), getattr(sh, name)
            if name in ("gamma", "d"):
                q = shard.gather(q)
            floor = 1e-12 * (1.0 + float(p.abs().max()))
            worst = max(worst, float(((q - p).abs() - 1e-12 * p.abs()).max()) / floor)
        same_ints = bool(
            torch.equal(plain.basis, sh.basis)
            and torch.equal(plain.in_basis, shard.gather(sh.in_basis))
            and int(plain.iteration) == int(sh.iteration)
            and int(plain.price_start) == int(sh.price_start)
        )
        result[str(pricing)] = {"plain": seqs[0], "sharded": seqs[1],
                                "state_ratio": worst, "same_ints": same_ints,
                                "pivots": int(plain.iteration)}
    return result


def _lu_walk(problem, A, c, mask, duplicate=False):
    # The LU chunk from the phase-1 start, sharded and unsharded, every
    # pricing rule: the (q, r) sequence of 40 one-pivot chunks each way,
    # then one 40-pivot chunk each way and its state side by side.
    # duplicate: the tableau [A, A], every key tied across ranks.
    cfg = SolverConfig(platform="cpu", dtype="float64", pad_to=8, refactor_period=64)
    engine = LUEngine(torch.device("cpu"))
    start0 = engine.init_state(problem, cfg)
    if duplicate:
        A, c, mask = (torch.cat([v, v], dim=-1) for v in (A, c, mask))
        start0 = start0._replace(in_basis=torch.cat([start0.in_basis,
                                                     torch.zeros_like(start0.in_basis)]),
                                 gamma=torch.cat([start0.gamma, start0.gamma]))
    N = A.shape[1]
    mesh = make_mesh((1, world))
    shard = column_shard(mesh, N, "cpu")
    A_s, _, c_s, mask_s = shard_problem(mesh, A, None, c, mask)
    result = {}
    for pricing in range(5):
        kw = dict(pricing=pricing, opt_tol=1e-9, pivot_tol=1e-9, degen_tol=1e-9,
                  stop_at_zero=True)
        start = start0
        if pricing == kernels.PRICE_STEEPEST:
            start = engine.recompute_gamma(start, A)
        # A resume point past the middle: the rotation must use global ids.
        start = start._replace(price_start=torch.tensor(N // 2 + 1, dtype=torch.int32))
        seqs = []
        for sharded in (False, True):
            s = shard_state(mesh, start, N) if sharded else start
            seq = []
            for _ in range(40):
                before = s.basis.clone()
                if sharded:
                    s = sharded_run_chunk(shard, s, A_s, A_s, c_s, mask_s, chunk=1, **kw)
                else:
                    s = lu_mod.lu_run_chunk(s, A, A, c, mask, chunk=1, **kw)
                r = torch.nonzero(s.basis != before).flatten()
                if r.numel():
                    seq.append([int(s.basis[r[0]]), int(r[0])])
                if int(s.status) != RUNNING or float(s.obj) <= 1e-9:
                    break
            seqs.append(seq)
        plain = lu_mod.lu_run_chunk(start, A, A, c, mask, chunk=40, **kw)
        sh = sharded_run_chunk(shard, shard_state(mesh, start, N), A_s, A_s, c_s, mask_s,
                               chunk=40, **kw)
        worst = 0.0
        for name in ("xB", "pi", "obj", "gamma", "eta_vals"):
            p, q = getattr(plain, name), getattr(sh, name)
            if name == "gamma":
                q = shard.gather(q)
            floor = 1e-12 * (1.0 + float(p.abs().max()))
            worst = max(worst, float(((q - p).abs() - 1e-12 * p.abs()).max()) / floor)
        same_ints = bool(
            torch.equal(plain.basis, sh.basis)
            and torch.equal(plain.in_basis, shard.gather(sh.in_basis))
            and torch.equal(plain.eta_rows, sh.eta_rows)
            and int(plain.eta_count) == int(sh.eta_count)
            and int(plain.iteration) == int(sh.iteration)
            and int(plain.price_start) == int(sh.price_start)
        )
        result[str(pricing)] = {"plain": seqs[0], "sharded": seqs[1],
                                "state_ratio": worst, "same_ints": same_ints,
                                "pivots": int(plain.iteration), "N": N}
    return result


def lu_chunk_case(duplicate=False):
    gf = testing.generated_lp(24, 64, 7)
    gf.presolve()
    problem = lower_provider(gf.derive_matrix_data(gf.standardize()),
                             dtype=np.float64, pad_to=8)
    return _lu_walk(problem, torch.as_tensor(problem.A), torch.as_tensor(problem.c_phase1),
                    torch.as_tensor(problem.candidate_mask), duplicate)


def relaxation_case(**overrides):
    mesh = make_mesh((1, world))
    cfg = SolverConfig(**CPU, **overrides)
    return {
        "provider6": verdict(solve_relaxation(parallel._provider(6)[0], cfg, mesh=mesh)),
        "knap6": verdict(solve_relaxation(knap6_md(), cfg, mesh=mesh)),
    }


def batch_case(shape, scenarios):
    mesh = make_mesh(shape)
    results = solve_batch([parallel._provider(b2)[0] for b2 in scenarios],
                          SolverConfig(**CPU), mesh=mesh)
    return [verdict(r) for r in results]


def pdhg_case(shape):
    A, b, c, u = _random_lp()
    x, y, stats = pdhg_solve(A, b, c, u, tol=1e-8, dtype=np.float64, device="cpu",
                             mesh=make_mesh(shape))
    return {"converged": bool(stats.converged), "objective": float(c @ x),
            "residual": float(np.linalg.norm(A @ x - b)), "x_shape": list(x.shape),
            "y_shape": list(y.shape)}


def mip_case(**overrides):
    gf = load_general_form(KNAP6)
    mip = solve_mip(gf, SolverConfig(platform="cpu", **overrides),
                    mesh=make_mesh((1, world)))
    return {"objective": str(mip.objective), "certified": bool(mip.certified)}


def tie_case():
    mesh = make_mesh((1, world))
    N = 4 * world + 1
    shard = column_shard(mesh, N, "cpu")
    inf = float("inf")
    found = {}
    yes = torch.tensor(True)
    # Equal keys on every rank: the lowest global index (rank 0's) wins.
    q, _ = shard.best(torch.full((shard.n,), 2.0), torch.tensor(1), yes)
    found["equal_keys"] = int(q) == 1
    # A NaN on the last rank beats larger keys elsewhere, as under argmax.
    key = torch.full((shard.n,), float("nan") if shard.rank == world - 1 else 5.0)
    q, _ = shard.best(key, torch.tensor(0), yes)
    found["nan_wins"] = int(q) == N - shard.widths[-1]  # the last rank's first
    # NaN everywhere: the lowest index.
    q, _ = shard.best(torch.full((shard.n,), float("nan")), torch.tensor(2), yes)
    found["nan_everywhere"] = int(q) == 2
    # Every pricing rule on d with ties that span the ranks, against the
    # unsharded choice.
    rules = {}
    for pricing in range(5):
        for case in range(6):
            rng = np.random.default_rng(case)
            d = -np.round(rng.uniform(0, 2, N))  # many exact ties
            if case == 4:
                d[N - 1] = np.nan  # argmax over a NaN key
            eligible = rng.uniform(size=N) < (0.0 if case == 5 else 0.6)
            gamma = np.ones(N)
            start = torch.tensor(int(rng.integers(N)), dtype=torch.int32)
            full = [torch.as_tensor(v) for v in (d, gamma, eligible)]
            q0, any0 = kernels._select_entering(*full, pricing, N, start=start)
            local = [shard.take(v) for v in full]
            q1, any1 = kernels._select_entering(*local, pricing, N, start=start,
                                                shard=shard)
            rules[f"{pricing}/{case}"] = [int(q0), int(q1), bool(any0), bool(any1)]
    found["rules"] = rules
    return found


def bad_shape_case():
    try:
        make_mesh((3, world))
    except ValueError:
        return True
    return False


cases = {"chunk": chunk_case, "relaxation": relaxation_case, "tie": tie_case,
         "bad_shape": bad_shape_case, "lu_chunk": lu_chunk_case,
         "lu_tie": lambda: lu_chunk_case(duplicate=True),
         "lu_relaxation": lambda: relaxation_case(basis_inverse="lu"),
         "lu_bf16": lambda: relaxation_case(basis_inverse="lu", scan_dtype="bfloat16")}
if world == 2:
    cases["mip"] = mip_case
    cases["lu_mip"] = lambda: mip_case(basis_inverse="lu")
    cases["batch_2x1"] = lambda: batch_case((2, 1), (6, 7, 8, 9))
    cases["pdhg_2x1"] = lambda: pdhg_case((2, 1))
if world == 4:
    cases["batch_2x2"] = lambda: batch_case((2, 2), (6, 7, 8, 9))
    cases["batch_2x2_replicated"] = lambda: batch_case((2, 2), (6, 7, 8))
    cases["pdhg_2x2"] = lambda: pdhg_case((2, 2))
for name, case in cases.items():
    out[name] = case()
out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "relp_tpu"))
dist.destroy_process_group()
if rank == 0:
    with open(out_path, "w") as f:
        json.dump(out, f)
print(f"rank {rank} OK", flush=True)
"""


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of one in this process (no torchrun
    environment), destroyed on exit; yields the (1, 1) mesh."""
    import torch.distributed as dist

    from relp_tpu_torch.parallel import initialize_multihost, make_mesh

    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")
           if k in os.environ}
    initialize_multihost(platform="cpu")
    try:
        yield make_mesh((1, 1))
    finally:
        dist.destroy_process_group()
        os.environ.update(env)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(world: int, out_path: pathlib.Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(world), port, str(out_path)],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"world {world}: workers timed out; output so far: {outputs}")
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"world {world} rank {rank} failed:\n{out[-4000:]}"
    return json.loads(out_path.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world size: the findings of every case}: one launch per size in the
    whole test run.  pytest-xdist workers share the findings through
    pytest's base temporary directory under a file lock, so that each
    worker that runs a case here does not launch its own worlds beside the
    others."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # shared by every worker of the run
    shared = base / "torch_mesh_runs"
    shared.mkdir(exist_ok=True)
    found = {}
    with FileLock(str(shared / "lock")):
        for world in (2, 4):
            path = shared / f"world{world}.json"
            found[world] = (json.loads(path.read_text()) if path.exists()
                            else _launch(world, path))
    return found


def _knap6_md(port: bool):
    gf = (load_general_form if port else jax_load_general_form)(str(DATA / "knap6.mps"))
    gf.presolve()
    return gf.derive_matrix_data(gf.standardize())


def _provider6(port: bool):
    helper = twin("tests.test_parallel") if port else __import__(
        "tests.test_parallel", fromlist=["_provider"])
    return helper._provider(6)[0]


def _verdict(r):
    return [r.status.value, str(r.exact_objective), r.basis, r.stats.iterations,
            bool(r.stats.certified)]


WORLDS = (2, 4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("pricing", range(5))
def test_sharded_chunk_walks_the_unsharded_pivots(runs, world, pricing):
    found = runs[world]["chunk"][str(pricing)]
    assert found["sharded"] == found["plain"] and len(found["plain"]) > 0
    assert found["same_ints"] and found["pivots"] >= len(found["plain"])
    assert found["state_ratio"] <= 1.0  # |diff| <= 1e-12 (|x| + 1 + max|x|)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["provider6", "knap6"])
def test_solve_relaxation_with_mesh_matches_unsharded_and_jax(runs, world, name):
    build = {"provider6": _provider6, "knap6": _knap6_md}[name]
    plain = solve_relaxation(build(True), SolverConfig(platform="cpu", **CPU))
    jax_res = jax_solve_relaxation(build(False), JaxConfig(**CPU))
    sharded = runs[world]["relaxation"][name]
    assert sharded == _verdict(plain)
    assert sharded[:3] == [jax_res.status.value, str(jax_res.exact_objective),
                           jax_res.basis]
    assert sharded[4] is True


def _plain_batch(scenarios):
    providers = [twin("tests.test_parallel")._provider(b2)[0] for b2 in scenarios]
    return [_verdict(r) for r in solve_batch(providers, SolverConfig(platform="cpu", **CPU))]


@pytest.mark.parametrize("case, world, scenarios", [
    ("batch_2x2", 4, (6, 7, 8, 9)),
    ("batch_2x1", 2, (6, 7, 8, 9)),
    ("batch_2x2_replicated", 4, (6, 7, 8)),
])
def test_solve_batch_with_mesh_matches_unsharded(runs, case, world, scenarios):
    sharded = runs[world][case]
    assert sharded == _plain_batch(scenarios)
    for b2, found in zip(scenarios, sharded):
        assert found[0] == "finite_optimum" and found[4] is True
        assert Fraction(found[1]) == -Fraction(b2 + 8, 5)


@pytest.mark.parametrize("case, world", [("pdhg_2x2", 4), ("pdhg_2x1", 2)])
def test_pdhg_with_mesh_converges_to_the_unsharded_optimum(runs, case, world):
    A, b, c, u = _random_lp()
    x0, _, s0 = pdhg_solve(A, b, c, u, tol=1e-8, dtype=np.float64, device="cpu")
    found = runs[world][case]
    assert s0.converged and found["converged"]
    assert found["x_shape"] == [A.shape[1]] and found["y_shape"] == [A.shape[0]]
    assert abs(found["objective"] - float(c @ x0)) <= 1e-6 * (1 + abs(float(c @ x0)))
    assert found["residual"] < 1e-6 * (1 + np.linalg.norm(b))


@pytest.mark.parametrize("case", ["mip", "lu_mip"])
def test_solve_mip_with_mesh_proves_knap6(runs, case):
    assert runs[2][case] == {"objective": "-30", "certified": True}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("pricing", range(5))
def test_sharded_lu_chunk_walks_the_unsharded_pivots(runs, world, pricing):
    found = runs[world]["lu_chunk"][str(pricing)]
    assert found["sharded"] == found["plain"] and len(found["plain"]) > 0
    assert found["same_ints"] and found["pivots"] >= len(found["plain"])
    assert found["state_ratio"] <= 1.0  # |diff| <= 1e-12 (|x| + 1 + max|x|)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("pricing", range(5))
def test_lu_ties_across_ranks_take_the_lowest_global_index(runs, world, pricing):
    """The LU chunk on [A, A]: every key of the first copy ties with its
    twin on another rank, and the sharded walk is the unsharded one, whose
    keyed rules enter from the first copy only."""
    found = runs[world]["lu_tie"][str(pricing)]
    assert found["sharded"] == found["plain"] and len(found["plain"]) > 0
    assert found["same_ints"] and found["state_ratio"] <= 1.0
    if pricing in (0, 1, 2, 3):  # the rotated rule starts past the middle
        assert all(q < found["N"] // 2 for q, _r in found["plain"])


def _jax_lu_mesh_verdict(build):
    from relp_tpu.parallel import make_mesh as jax_make_mesh

    res = jax_solve_relaxation(build(False), JaxConfig(basis_inverse="lu", **CPU),
                               mesh=jax_make_mesh((1, 8)))
    return [res.status.value, str(res.exact_objective), res.basis]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["provider6", "knap6"])
def test_lu_solve_relaxation_with_mesh_matches_unsharded_and_jax(runs, world, name):
    build = {"provider6": _provider6, "knap6": _knap6_md}[name]
    plain = solve_relaxation(build(True),
                             SolverConfig(platform="cpu", basis_inverse="lu", **CPU))
    sharded = runs[world]["lu_relaxation"][name]
    assert sharded == _verdict(plain)
    assert sharded[:3] == _jax_lu_mesh_verdict(build)
    assert sharded[4] is True


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["provider6", "knap6"])
def test_lu_bfloat16_scan_with_mesh_matches_unsharded(runs, world, name):
    """scan_dtype="bfloat16": the LU chunk's low-precision pricing branch
    (the |pi|-scaled eligibility floor and the recheck of the pick) under a
    shard, then the full-precision polish."""
    build = {"provider6": _provider6, "knap6": _knap6_md}[name]
    plain = solve_relaxation(build(True), SolverConfig(
        platform="cpu", basis_inverse="lu", scan_dtype="bfloat16", **CPU))
    sharded = runs[world]["lu_bf16"][name]
    assert sharded == _verdict(plain)
    assert sharded[4] is True


@pytest.mark.parametrize("world", WORLDS)
def test_ties_across_ranks_take_the_lowest_global_index(runs, world):
    found = runs[world]["tie"]
    assert found["equal_keys"] and found["nan_wins"] and found["nan_everywhere"]
    for key, (q0, q1, any0, any1) in found["rules"].items():
        assert (q1, any1) == (q0, any0), key


@pytest.mark.parametrize("world", WORLDS)
def test_a_mesh_shape_that_does_not_hold_the_world_raises(runs, world):
    assert runs[world]["bad_shape"] is True
    assert runs[world]["jax_loaded"] == []  # the workers ran the port alone


@pytest.mark.parametrize("basis_inverse", ["dense", "lu"])
def test_world_of_one_in_process_equals_unsharded(basis_inverse):
    """initialize_multihost with no arguments (no torchrun environment) is a
    world of one; a (1, 1) mesh solves knap6 and _provider(6) on either
    engine as the unsharded port does, and a shape of two ranks raises."""
    import torch.distributed as dist

    from relp_tpu_torch.parallel import make_mesh, sharded

    with world_of_one() as mesh:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        with pytest.raises(ValueError):
            make_mesh((1, 2))
        cfg = SolverConfig(platform="cpu", basis_inverse=basis_inverse, **CPU)
        for build in (_knap6_md, _provider6):
            sharded.COLLECTIVES = 0
            assert _verdict(solve_relaxation(build(True), cfg, mesh=mesh)) == \
                _verdict(solve_relaxation(build(True), cfg))
            assert sharded.COLLECTIVES > 0
        A, b, c, u = _random_lp()
        x0, y0, _ = pdhg_solve(A, b, c, u, tol=1e-8, dtype=np.float64, device="cpu")
        x1, y1, _ = pdhg_solve(A, b, c, u, tol=1e-8, dtype=np.float64, device="cpu",
                               mesh=mesh)
        np.testing.assert_allclose(x1, x0, rtol=1e-9, atol=1e-9)
