"""The port's mesh sharding over ``torch.distributed`` (gloo, on the CPU).

Two launches of 2 and two of 4 worker processes (spawned as
tests/test_multihost.py spawns them, one torch thread each, a hard 120 s
timeout on every process; one launch for the eager cases, one for the
``graph_*`` cases) run every case and write their findings as JSON; each
case below is a test of its own that reads them, beside the unsharded
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
  an 8-device mesh, with a full and a bfloat16 scan;
* the sharded loops through the recording stand-in for a CUDA graph
  (``testing.recording_graphs``: collectives recorded and replayed), bit
  for bit against the same loops eager on every rank, a replay's
  collectives the eager run's: the dense and LU chunks (f64, every
  pricing rule, the LU chunk entering with 0, 6 and 12 etas) with the
  columns split unevenly, ``pdhg_solve`` on the 2x1 and 2x2 grids, and
  each sharded batch step (``testing.step_case`` with a (1, world) or
  (2, 2) mesh);
* three ``solve_batch(mesh=...)`` calls of one shape: the eager verdicts,
  the second and third calls using only the first call's keys and
  capturing nothing;
* ranks whose column blocks differ in width under a byte bound between
  their caches' sizes: the same evictions on every rank (the agreed
  count), the eager verdicts, no hang.

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
from relp_tpu_torch.testing import scenario_family
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
graph_part = sys.argv[5] == "graph"  # the graph_* cases, or the others
from relp_tpu_torch.parallel import (
    column_shard, initialize_multihost, make_mesh, shard_problem, shard_state,
    sharded_run_chunk, shutdown_multihost,
)
initialize_multihost(f"localhost:{port}", world, rank, platform="cpu")

from relp_tpu_torch import testing
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.firstorder.pdhg import pdhg_solve
from relp_tpu_torch.io import load_general_form
from relp_tpu_torch.mip import solve_mip
from relp_tpu_torch.parallel import sharded, solve_batch
from relp_tpu_torch.simplex import graphs, kernels, solve_relaxation
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


def everywhere(flag):
    # flag on every rank (a MIN all_reduce, not counted)
    t = torch.tensor([1 if flag else 0])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t)


def each_rank(value):
    # the value of every rank, in rank order
    parts = [None] * world
    dist.all_gather_object(parts, value)
    return parts


def same_bits(got, want):
    return all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(
        g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))
        for g, w in zip(got, want))


def counted(fn):
    # fn()'s result and the collectives it counted
    before = sharded.COLLECTIVES
    out = fn()
    return out, sharded.COLLECTIVES - before


def graph_chunk_case(engine_cls):
    # The sharded dense or LU chunk (f64, every pricing rule, phase 1) of
    # the generated LP lowered without padding (N not a multiple of the
    # ranks), replayed through the recording stand-in against the eager
    # sharded chunk (fixed length, as captured), three chunks in a row:
    # bitwise equal on every rank, and a replay's collectives the eager
    # chunk's.  The LU chunks enter with 0, 6 and 12 etas in the ring.
    gf = testing.generated_lp(24, 63, 7)  # N = 229
    gf.presolve()
    problem = lower_provider(gf.derive_matrix_data(gf.standardize()),
                             dtype=np.float64, pad_to=1)
    cfg = SolverConfig(platform="cpu", dtype="float64", scan_dtype="same", pad_to=1,
                       refactor_period=64)
    engine = engine_cls(torch.device("cpu"))
    A, b, c, mask = (torch.as_tensor(x) for x in (problem.A, problem.b, problem.c_phase1,
                                                   problem.candidate_mask))
    mesh = make_mesh((1, world))
    shard = column_shard(mesh, problem.N, "cpu")
    A_s, _, c_s, mask_s = shard_problem(mesh, A, b, c, mask)
    lu_chunk = engine_cls is LUEngine
    body = lu_mod.lu_run_chunk if lu_chunk else kernels.run_chunk
    result = {"N": problem.N, "widths": shard.widths}
    for pricing in range(5):
        kw = dict(pricing=pricing, chunk=6, opt_tol=1e-9, pivot_tol=1e-9, degen_tol=1e-9,
                  stop_at_zero=True, shard=shard)
        start = engine.init_state(problem, cfg)
        if pricing == kernels.PRICE_STEEPEST:
            start = engine.recompute_gamma(start, A)
        eager = graphed = shard_state(mesh, start, problem.N)
        bitwise, collectives, entries = True, [], []
        with testing.recording_graphs():
            cache = graphs.ChunkGraphs()
            for _ in range(3):
                entries.append(int(eager.eta_count) if lu_chunk else 0)
                eager, n_eager = counted(lambda: body(eager, A_s, A_s, c_s, mask_s,
                                                      early_exit=False, **kw))
                run = cache.lu_run_chunk if lu_chunk else cache.run_chunk
                graphed, n_graphed = counted(lambda: run(graphed, A_s, A_s, c_s, mask_s,
                                                         **kw))
                bitwise &= same_bits(graphed, eager)
                collectives.append([n_eager, n_graphed])
        result[str(pricing)] = {"bitwise": everywhere(bitwise), "collectives": collectives,
                                "captures": len(cache._entries), "eta0": entries,
                                "pivots": int(eager.iteration)}
    return result


def graph_pdhg_case(shape):
    # pdhg_solve(mesh=...) with its chunks through the recording stand-in
    # against the same call eager: the same point, bit for bit, and
    # statistics; one capture.
    A, b, c, u = _random_lp()
    kw = dict(tol=1e-8, max_iters=1_000, dtype=np.float64, device="cpu",
              mesh=make_mesh(shape))
    (x0, y0, s0), n_eager = counted(lambda: pdhg_solve(A, b, c, u, **kw))
    with testing.recording_graphs():
        captures, replays = graphs.CAPTURES, graphs.REPLAYS
        (x1, y1, s1), n_graphed = counted(lambda: pdhg_solve(A, b, c, u, **kw))
        captures, replays = graphs.CAPTURES - captures, graphs.REPLAYS - replays
    return {"bitwise": everywhere(x0.tobytes() == x1.tobytes() and y0.tobytes() == y1.tobytes()),
            "stats": [vars(s0) | {"wall_time_s": 0}, vars(s1) | {"wall_time_s": 0}],
            "collectives": [n_eager, n_graphed], "captures": captures, "replays": replays,
            "iterations": s0.iterations, "restarts": s0.restarts}


STEP_FAMILY = dict(m=16, n=48, seed=7, count=4)  # lowered 4 x 128x256


def graph_batch_step_case(shape):
    # Each sharded step of solve_batch(mesh=...) (testing.step_case with the
    # mesh) through the mesh group's cache of steps against the eager step
    # (fixed length), three steps after the key's first use: step and
    # report bitwise equal on every rank, a replay's collectives the eager
    # step's.
    from relp_tpu_torch.parallel.batch_driver import _batch_step, run_step

    mesh = make_mesh(shape)
    result = {}
    for kind in ("torch_float32", "torch_float64", "polish"):
        body, state, inputs, static = testing.step_case(kind, STEP_FAMILY, chunk=10,
                                                        mesh=mesh)
        bitwise, collectives = True, []
        with testing.recording_graphs():
            run_step(body, state, inputs, graphed=True, **static)  # the first use
            eager = graphed = state
            replays = graphs.REPLAYS
            for _ in range(3):
                e, n_eager = counted(lambda: body(eager, **inputs, early_exit=False,
                                                  **static))
                g, n_graphed = counted(lambda: run_step(body, graphed, inputs,
                                                        graphed=True, **static))
                if body is _batch_step:
                    bitwise &= same_bits(g[1:], e[1:])
                    g, e = g[0], e[0]
                bitwise &= same_bits(g, e)
                collectives.append([n_eager, n_graphed])
                graphed, eager = g, e
            replays = graphs.REPLAYS - replays
        result[kind] = {"bitwise": everywhere(bitwise), "collectives": collectives,
                        "replays": replays,
                        "pivots": int((eager.iteration - state.iteration).sum())}
    return result


# solve_batch's configuration for the mesh graph cases: no padding, so that
# the family's 107 columns split unevenly over 2 and 4 ranks.
UNEVEN = dict(platform="cpu", pad_to=1, chunk_size=5, refactor_period=5)


def batch_verdicts(mesh):
    results = solve_batch(testing.scenario_family(12, 30, 7, 4), SolverConfig(**UNEVEN),
                          shared_structure=True, mesh=mesh)
    return [verdict(r) for r in results]


def graph_batch_solve_case():
    # solve_batch(mesh=...) eager, then three calls of the same shape
    # through the recording stand-in: the eager verdicts each time; the
    # second call's keys all seen by the first, the third capturing none.
    mesh = make_mesh((1, world))
    eager = batch_verdicts(mesh)
    calls = []
    with testing.recording_graphs():
        for _ in range(3):
            captures, replays = graphs.CAPTURES, graphs.REPLAYS
            found = batch_verdicts(mesh)
            cache = graphs.steps(mesh.get_group("col"))
            calls.append({"same": found == eager, "captures": graphs.CAPTURES - captures,
                          "replays": graphs.REPLAYS - replays, "seen": len(cache._seen),
                          "entries": len(cache._entries)})
        caches = len(graphs._GROUP_STEPS), graphs._STEPS is None
    return {"calls": calls, "caches": caches, "verdicts": eager}


def graph_evictions_case():
    # N not a multiple of the ranks: each rank's cache of steps holds other
    # bytes.  A first graphed call measures them; a second, from empty
    # caches, runs under a byte bound between the smallest and the largest
    # rank's: the ranks must evict alike (the agreed count), finish, and
    # give the eager verdicts.
    mesh = make_mesh((1, world))
    group = mesh.get_group("col")
    eager = batch_verdicts(mesh)
    with testing.recording_graphs():
        batch_verdicts(mesh)
        held = each_rank(graphs.steps(group).nbytes())
    bound = (min(held) + max(held)) // 2
    kept_bound, graphs.STEP_CACHE_BYTES = graphs.STEP_CACHE_BYTES, bound
    try:
        with testing.recording_graphs():
            evictions = graphs.EVICTIONS
            found = batch_verdicts(mesh)
            evicted = each_rank(graphs.EVICTIONS - evictions)
            entries = each_rank(len(graphs.steps(group)._entries))
    finally:
        graphs.STEP_CACHE_BYTES = kept_bound
    return {"held": held, "bound": bound, "evicted": evicted, "entries": entries,
            "same": everywhere(found == eager)}


cases = {"chunk": chunk_case, "relaxation": relaxation_case, "tie": tie_case,
         "bad_shape": bad_shape_case, "lu_chunk": lu_chunk_case,
         "lu_tie": lambda: lu_chunk_case(duplicate=True),
         "lu_relaxation": lambda: relaxation_case(basis_inverse="lu"),
         "lu_bf16": lambda: relaxation_case(basis_inverse="lu", scan_dtype="bfloat16"),
         "graph_chunk": lambda: graph_chunk_case(DenseEngine),
         "graph_lu_chunk": lambda: graph_chunk_case(LUEngine),
         "graph_batch_step": lambda: graph_batch_step_case((1, world)),
         "graph_batch_solve": graph_batch_solve_case,
         "graph_evictions": graph_evictions_case}
if world == 2:
    cases["mip"] = mip_case
    cases["lu_mip"] = lambda: mip_case(basis_inverse="lu")
    cases["batch_2x1"] = lambda: batch_case((2, 1), (6, 7, 8, 9))
    cases["pdhg_2x1"] = lambda: pdhg_case((2, 1))
    cases["graph_pdhg_2x1"] = lambda: graph_pdhg_case((2, 1))
if world == 4:
    cases["batch_2x2"] = lambda: batch_case((2, 2), (6, 7, 8, 9))
    cases["batch_2x2_replicated"] = lambda: batch_case((2, 2), (6, 7, 8))
    cases["pdhg_2x2"] = lambda: pdhg_case((2, 2))
    cases["graph_pdhg_2x2"] = lambda: graph_pdhg_case((2, 2))
    cases["graph_batch_step_2x2"] = lambda: graph_batch_step_case((2, 2))
for name, case in cases.items():
    if name.startswith("graph_") == graph_part:
        out[name] = case()
out["jax_loaded_" + sys.argv[5]] = sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "relp_tpu"))
shutdown_multihost()
if rank == 0:
    with open(out_path, "w") as f:
        json.dump(out, f)
print(f"rank {rank} OK", flush=True)
"""


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of one in this process (no torchrun
    environment), shut down on exit; yields the (1, 1) mesh."""
    from relp_tpu_torch.parallel import initialize_multihost, make_mesh, shutdown_multihost

    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")
           if k in os.environ}
    initialize_multihost(platform="cpu")
    try:
        yield make_mesh((1, 1))
    finally:
        shutdown_multihost()
        os.environ.update(env)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(world: int, out_path: pathlib.Path, part: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(world), port, str(out_path), part],
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
        pytest.fail(f"world {world} ({part}): workers timed out; output so far: {outputs}")
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"world {world} ({part}) rank {rank} failed:\n{out[-4000:]}"
    return json.loads(out_path.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world size: the findings of every case}: two launches per size in
    the whole test run, one for the graph_* cases (the recording stand-in)
    and one for the others, each process within its own timeout.
    pytest-xdist workers share the findings through pytest's base temporary
    directory under a file lock, so that each worker that runs a case here
    does not launch its own worlds beside the others."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # shared by every worker of the run
    shared = base / "torch_mesh_runs"
    shared.mkdir(exist_ok=True)
    found = {}
    with FileLock(str(shared / "lock")):
        for world in (2, 4):
            found[world] = {}
            for part in ("eager", "graph"):
                path = shared / f"world{world}_{part}.json"
                found[world].update(json.loads(path.read_text()) if path.exists()
                                    else _launch(world, path, part))
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
    # the workers of both launches (eager cases, graph_* cases) ran the port alone
    assert runs[world]["jax_loaded_eager"] == []
    assert runs[world]["jax_loaded_graph"] == []


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["graph_chunk", "graph_lu_chunk"])
@pytest.mark.parametrize("pricing", range(5))
def test_replayed_sharded_chunks_equal_eager_sharded_chunks(runs, case, world, pricing):
    """The sharded dense and LU chunks through the recording stand-in (in
    place of a CUDA graph, the collectives recorded and replayed) against
    the eager sharded chunks, on columns split unevenly over the ranks:
    bitwise equal on every rank, three chunks in a row, each replay's
    collectives the eager chunk's; the LU chunks enter with 0, 6 and 12
    etas, a capture each."""
    found = runs[world][case]
    assert found["N"] % world and len(set(found["widths"])) == 2
    one = found[str(pricing)]
    assert one["bitwise"] and one["pivots"] > 0
    assert all(n_eager == n_graphed > 0 for n_eager, n_graphed in one["collectives"])
    if case == "graph_lu_chunk":
        assert one["eta0"] == [0, 6, 12] and one["captures"] == 3
    else:
        assert one["captures"] == 1


@pytest.mark.parametrize("case, world", [("graph_pdhg_2x1", 2), ("graph_pdhg_2x2", 4)])
def test_replayed_pdhg_with_mesh_equals_eager(runs, case, world):
    """pdhg_solve(mesh=...) with its chunks through the stand-in (the
    grid's reductions recorded), cut at 1,000 iterations: the eager point
    bit for bit on every rank, the same statistics and collectives; one
    capture, a replay a chunk, restarts among them."""
    found = runs[world][case]
    assert found["bitwise"] and found["stats"][0] == found["stats"][1]
    assert found["collectives"][0] == found["collectives"][1] > 0
    assert found["captures"] == 1 and found["replays"] == found["iterations"] // 200
    assert found["restarts"] > 0  # a replay after a restart's new anchor and k0


@pytest.mark.parametrize("case, world, kind", [
    (case, world, kind) for case, world in (("graph_batch_step", 2), ("graph_batch_step", 4),
                                            ("graph_batch_step_2x2", 4))
    for kind in ("torch_float32", "torch_float64", "polish")])
def test_replayed_sharded_batch_steps_equal_eager_steps(runs, case, world, kind):
    """Each sharded step of solve_batch(mesh=...) (testing.step_case with a
    (1, world) or (2, 2) mesh) through the mesh group's cache of steps:
    bitwise equal to the eager step on every rank, three steps in a row, a
    replay's collectives the eager step's."""
    found = runs[world][case][kind]
    assert found["bitwise"] and found["pivots"] > 0
    assert all(n_eager == n_graphed > 0 for n_eager, n_graphed in found["collectives"])
    assert found["replays"] == (2 if kind == "polish" else 3)


@pytest.mark.parametrize("world", WORLDS)
def test_a_second_solve_batch_with_mesh_reuses_the_first_calls_keys(runs, world):
    """Three solve_batch(mesh=...) calls of one shape through the stand-in:
    the eager verdicts each time (the unsharded port's too); the first
    captures every key it uses (each repeats within the call), the second
    uses no key the first did not and replays them all (the shard is keyed
    by value, not by the new shard object of each call), the third too; one
    cache, the mesh column group's."""
    found = runs[world]["graph_batch_solve"]
    first, second, third = found["calls"]
    assert all(call["same"] for call in found["calls"])
    assert first["captures"] > 0 and first["entries"] == first["seen"]
    assert second["seen"] == first["seen"] and second["captures"] == 0
    assert second["replays"] > 0
    assert third["captures"] == 0 and third["replays"] > 0
    assert third["entries"] == second["entries"] >= first["entries"]
    assert found["caches"] == [1, True]
    assert found["verdicts"] == [_verdict(r) for r in solve_batch(
        scenario_family(12, 30, 7, 4),
        SolverConfig(platform="cpu", pad_to=1, chunk_size=5, refactor_period=5),
        shared_structure=True)]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_with_uneven_columns_evict_alike(runs, world):
    """A byte bound between the smallest and the largest rank's cache of
    steps (columns split unevenly): every rank evicts the same entries, as
    the largest count over the group decides, the call finishes and gives
    the eager verdicts."""
    found = runs[world]["graph_evictions"]
    assert min(found["held"]) < found["bound"] < max(found["held"])
    assert found["evicted"][0] > 0 and len(set(found["evicted"])) == 1
    assert len(set(found["entries"])) == 1 and found["same"]


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
