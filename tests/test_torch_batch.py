"""The port's scenario-batch path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages:

* the batched chunk runners (``batched_run_chunk``, ``batched_dual_run_chunk``)
  chunk by chunk from one batched state: identical basis, in_basis, status
  and iteration per LP after every chunk; the float state within rtol 1e-12
  (floor 1e-12 (1 + max|field|)) in f64, and within 1e-4 (1 + max|field|)
  in f32 (1e-3 for gamma, whose Goldfarb recurrence cancels), where the two
  packages' different summation orders leave ~1e-6 relative differences
  after a few dozen pivots;
* the batched-pivot kernels' plain version against the Pallas kernels in
  interpret mode, at the shapes of tests/test_pallas_batch.py and with its
  tolerances (xB 1e-4, pi 1e-3, Binv 1e-3, gamma 1e-2) taken relative to
  1 + max|JAX| (gamma reaches ~1e3 there, and torch sums in another order);
* ``solve_batch`` end to end: the same status values, exact objectives,
  bases and iteration counts, each package building its providers with its
  own classes from the same source (``twin``).

The data is Gaussian (``__graft_entry__._synthetic_problem``) where pivots
are compared, so no two candidates tie and both packages walk one path.
"""

import dataclasses
import importlib
from fractions import Fraction
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_problem
from relp_tpu.config import SolverConfig as JaxConfig
from relp_tpu.parallel import batch as jb
from relp_tpu.parallel.batch_driver import solve_batch as jax_solve_batch
from relp_tpu.simplex import kernels as jk
from relp_tpu.simplex import state as jstate
from relp_tpu.simplex.driver import solve_relaxation as jax_solve_relaxation
import relp_tpu_torch.testing
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.ops import batch_pivot
from relp_tpu_torch.parallel import batch as tb
from relp_tpu_torch.parallel import solve_batch
from relp_tpu_torch.simplex import SolveStatus, solve_relaxation
from relp_tpu_torch.simplex.state import SimplexState, state_from_numpy
from relp_tpu_torch.testing import WARM_FAMILY, scenario_family
from tests.test_torch_host_copy import twin

F = Fraction


def _package(port: bool) -> SimpleNamespace:
    """One package's builders of the test inputs."""
    def pick(name):
        return twin(name) if port else importlib.import_module(name)

    dual, parallel = pick("tests.test_dual"), pick("tests.test_parallel")
    return SimpleNamespace(
        dual_provider=dual._provider, interval_provider=dual._interval_provider,
        parallel_provider=lambda b2: parallel._provider(b2)[0],
        # GeneralForm and its element classes (test_dual imports them all)
        GeneralForm=dual.GeneralForm, Objective=dual.Objective,
        RangedConstraintRelation=dual.RangedConstraintRelation,
        SparseColumnMatrix=dual.SparseColumnMatrix, Variable=dual.Variable,
        VariableType=dual.VariableType,
        testing=(relp_tpu_torch.testing if port
                 else twin("relp_tpu_torch.testing", "relp_tpu")),
    )


JAX, PORT = _package(False), _package(True)
INT_FIELDS = ("basis", "in_basis", "status", "iteration", "degen_count",
              "inner", "price_start")
FLOAT_FIELDS = ("Binv", "xB", "pi", "obj", "gamma", "d")
PIVOT_FIELDS = ("basis", "in_basis", "status", "iteration")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread for a module's tests, then the count it
    had.  Every CPU test file of the port imports this fixture.  Torch's
    default pool (one spinning OpenMP thread per core in each pytest
    worker) starves the other workers, and the JAX suite's sharded tests
    abort when a collective's threads miss XLA's 40 s rendezvous timeout
    (ROADMAP.md, Queue 3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy(B, m, n, dtype, pad=8, seed0=0):
    """B synthetic LPs at their artificial start: (arrays, state fields)."""
    probs = [_synthetic_problem(m=m, n=n, pad=pad, seed=seed0 + s, dtype=dtype)
             for s in range(B)]
    A, b, c1, c2, cand, basis = (np.stack(x) for x in zip(*probs))
    _, M, N = A.shape
    in_basis = np.zeros((B, N), dtype=bool)
    np.put_along_axis(in_basis, basis.astype(np.int64), True, axis=1)
    cB = np.take_along_axis(c1, basis.astype(np.int64), axis=1)
    zeros = np.zeros(B, dtype=np.int32)
    fields = dict(
        Binv=np.tile(np.eye(M, dtype=dtype), (B, 1, 1)), basis=basis, xB=b,
        pi=cB, obj=(cB * b).sum(axis=1).astype(dtype), in_basis=in_basis,
        gamma=np.ones((B, N), dtype=dtype), iteration=zeros, status=zeros,
        degen_count=zeros, inner=zeros, price_start=zeros,
        d=(c1 - np.einsum("bm,bmn->bn", cB, A)).astype(dtype),
    )
    return dict(A=A, b=b, c1=c1, c2=c2, cand=cand), fields


@pytest.mark.parametrize("m,n,pad,seed,dtype", [
    (24, 48, 8, 0, np.float64), (48, 192, 32, 2, np.float32),
    (1024, 4096, 128, 7, np.float32)])
def test_synthetic_problem_is_the_compile_checks(m, n, pad, seed, dtype):
    """The port's copy of the Gaussian LP gives the arrays of the JAX
    package's __graft_entry__._synthetic_problem."""
    from relp_tpu_torch.testing import synthetic_problem

    want = _synthetic_problem(m=m, n=n, pad=pad, seed=seed, dtype=dtype)
    got = synthetic_problem(m=m, n=n, pad=pad, seed=seed, dtype=dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _jax_state(fields):
    return jstate.SimplexState(**{k: jnp.asarray(v) for k, v in fields.items()})


def _np(state):
    return {k: np.asarray(getattr(state, k)) for k in SimplexState._fields}


def _assert_same(js, ts, tol, where):
    jn, tn = _np(js), {k: v.numpy() for k, v in ts._asdict().items()}
    for k in PIVOT_FIELDS:
        assert np.array_equal(jn[k], tn[k]), f"{k} differs {where}"
    for k in ("degen_count", "inner", "price_start"):
        assert np.array_equal(jn[k], tn[k]), f"{k} differs {where}"
    for k in FLOAT_FIELDS:
        f32 = jn[k].dtype == np.float32
        tol_k = 10 * tol if (f32 and k == "gamma") else tol
        floor = tol_k * (1.0 + float(np.abs(jn[k]).max(initial=0.0)))
        rtol = 0.0 if f32 else tol
        np.testing.assert_allclose(tn[k], jn[k], rtol=rtol, atol=floor,
                                   err_msg=f"{k} differs {where}")


def _tol(dtype):
    return 1e-12 if dtype == np.float64 else 1e-4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pricing", [jk.PRICE_STEEPEST, jk.PRICE_DANTZIG])
@pytest.mark.parametrize("stop_at_zero", [True, False])
def test_batched_run_chunk_matches_jax(dtype, pricing, stop_at_zero):
    """Phase 1 (artificial costs, stop_at_zero) or the real costs from the
    artificial start (artificials cost 0 there, so the walk is a phase 2)."""
    arr, fields = _toy(3, 24, 48, dtype)
    costs = "c1" if stop_at_zero else "c2"
    js, ts = _jax_state(fields), state_from_numpy(fields, "cpu")
    kw = dict(pricing=pricing, chunk=15, opt_tol=1e-7, pivot_tol=1e-7,
              degen_tol=1e-7, stop_at_zero=stop_at_zero)
    A_j, A_t = jnp.asarray(arr["A"]), torch.from_numpy(arr["A"])
    c_j, c_t = jnp.asarray(arr[costs]), torch.from_numpy(arr[costs])
    m_j, m_t = jnp.asarray(arr["cand"]), torch.from_numpy(arr["cand"])
    for chunk in range(3):
        js = jb.batched_run_chunk(js, A_j, A_j, c_j, m_j, **kw)
        ts = tb.batched_run_chunk(ts, A_t, A_t, c_t, m_t, **kw)
        _assert_same(js, ts, _tol(dtype), f"after chunk {chunk}")
    assert int(np.asarray(js.iteration).sum()) >= 30


def test_batched_run_chunk_refactor_cadence_matches_jax():
    """The in-chunk device refactorization every 10 steps (batched Newton
    refresh, xB clamp, fresh gamma), f64, phase 1 then phase 2 costs."""
    arr, fields = _toy(3, 24, 48, np.float64, seed0=5)
    js, ts = _jax_state(fields), state_from_numpy(fields, "cpu")
    j = {k: jnp.asarray(v) for k, v in arr.items()}
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    kw = dict(pricing=jk.PRICE_STEEPEST, chunk=35, opt_tol=1e-9, pivot_tol=1e-9,
              degen_tol=1e-9, refactor_period=10, newton_steps=1, feas_tol=1e-9)
    for c, stop in (("c1", True), ("c2", False)):
        js = jb.batched_run_chunk(js, j["A"], j["A"], j[c], j["cand"],
                                  stop_at_zero=stop, b=j["b"], **kw)
        ts = tb.batched_run_chunk(ts, t["A"], t["A"], t[c], t["cand"],
                                  stop_at_zero=stop, b=t["b"], **kw)
        _assert_same(js, ts, 1e-12, f"after the {c} chunk")
        js = js._replace(status=jnp.zeros_like(js.status))
        ts = ts._replace(status=torch.zeros_like(ts.status))
    assert int(np.asarray(js.iteration).min()) > 10


@pytest.mark.parametrize(
    "pricing", [jk.PRICE_STEEPEST, jk.PRICE_DANTZIG, jk.PRICE_BLAND,
                jk.PRICE_FIRST_MEMORY],
)
def test_batch_of_one_is_the_single_lp_chunk(pricing):
    """B=1 walks the single-LP run_chunk's pivots; the float state differs
    only by the summation order of a batched product (rtol 1e-12, f64)."""
    from relp_tpu_torch.simplex import kernels as tk

    arr, fields = _toy(1, 24, 48, np.float64, seed0=3)
    batch = state_from_numpy(fields, "cpu")
    single = SimplexState(*(f[0] for f in batch))
    A, c, cand = (torch.from_numpy(arr[k]) for k in ("A", "c1", "cand"))
    kw = dict(pricing=pricing, chunk=20, opt_tol=1e-9, pivot_tol=1e-9,
              degen_tol=1e-9)
    for _ in range(3):
        single = tk.run_chunk(single, A[0], A[0], c[0], cand[0], **kw)
        batch = tb.batched_run_chunk(batch, A, A, c, cand, **kw)
        for k in INT_FIELDS:
            assert torch.equal(getattr(batch, k)[0], getattr(single, k)), k
        for k in FLOAT_FIELDS:
            s = getattr(single, k).numpy()
            np.testing.assert_allclose(
                getattr(batch, k)[0].numpy(), s, rtol=1e-12,
                atol=1e-12 * (1.0 + np.abs(s).max()), err_msg=k)
    assert int(single.iteration) >= 40


def test_batched_dual_run_chunk_matches_jax():
    """The optimal basis of the generated LP (m=16, n=40, every variable
    boxed), then right-hand sides scaled by 0.5-1.5 per row and scenario:
    dual pivots restore primal feasibility in both packages, chunk by chunk
    (f64)."""
    import jax

    from relp_tpu_torch.simplex.lowering import lower_provider

    def provider(p):
        gf, counts = p.testing.scenario_base(16, 40, 7)
        return gf.derive_matrix_data(counts)

    base = jax_solve_relaxation(provider(JAX), JaxConfig(dtype="float64", pad_to=8))
    problem = lower_provider(provider(PORT), dtype=np.float64, pad_to=8)
    assert len(base.basis) == problem.m_real
    basis = problem.initial_basis.copy()
    basis[: problem.m_real] = base.basis
    B = 3
    rng = np.random.default_rng(2)
    b = np.tile(problem.b, (B, 1))
    b[:, : problem.m_real] *= rng.uniform(0.5, 1.5, size=(B, problem.m_real))
    j = {k: jnp.asarray(np.stack([getattr(problem, k)] * B))
         for k in ("A", "c_phase2", "candidate_mask")}
    j["b"] = jnp.asarray(b)
    bases = jnp.asarray(np.tile(basis, (B, 1)))
    X, xB, pi, obj, _ = jax.vmap(
        lambda A, b, c, bas: jk.refactorize(A, b, c, bas, newton_steps=3)
    )(j["A"], j["b"], j["c_phase2"], bases)
    in_basis = np.zeros((B, problem.N), dtype=bool)
    in_basis[:, basis] = True
    zeros = jnp.zeros(B, jnp.int32)
    js = jstate.SimplexState(
        Binv=X, basis=bases, xB=xB, pi=pi, obj=obj, in_basis=jnp.asarray(in_basis),
        gamma=jnp.ones((B, problem.N)), iteration=zeros, status=zeros,
        degen_count=zeros, inner=zeros, price_start=zeros,
        d=jnp.zeros((B, problem.N)),
    )
    assert (np.asarray(xB).min(axis=1) < -1e-6).all()  # primal infeasible now
    ts = state_from_numpy(js, "cpu")
    t = {k: torch.from_numpy(np.array(v)) for k, v in j.items()}
    dkw = dict(chunk=3, opt_tol=1e-9, pivot_tol=1e-9, feas_tol=1e-9)
    for chunk in range(20):
        js = jb.batched_dual_run_chunk(js, j["A"], j["A"], j["c_phase2"],
                                       j["candidate_mask"], **dkw)
        ts = tb.batched_dual_run_chunk(ts, t["A"], t["A"], t["c_phase2"],
                                       t["candidate_mask"], **dkw)
        _assert_same(js, ts, 1e-12, f"after dual chunk {chunk}")
        if not (np.asarray(js.status) == jstate.RUNNING).any():
            break
    assert int(np.asarray(js.iteration).min()) >= 1
    assert set(np.asarray(js.status).tolist()) <= {jstate.OPTIMAL, jstate.INFEASIBLE}


def _pallas_toy(B, m, n):
    """The batch of tests/test_pallas_batch.py::_toy_batch (pad 32, f32)."""
    arr, fields = _toy(B, m, n, np.float32, pad=32)
    return arr["A"], arr["c1"], arr["cand"], fields


@pytest.mark.parametrize("variant,m,n", [("resident", 32, 64), ("blocked", 48, 192)])
@pytest.mark.parametrize("stop_at_zero", [True, False])
def test_plain_version_matches_the_pallas_kernels(variant, m, n, stop_at_zero):
    from relp_tpu.ops import pallas_batch

    A, c, cand, f = _pallas_toy(3, m, n)
    args = (A, c, cand, f["Binv"], f["xB"], f["pi"], f["basis"], f["in_basis"],
            f["gamma"], f["status"], f["iteration"], f["degen_count"])
    kw = dict(chunk=25, opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7,
              stop_at_zero=stop_at_zero)
    if variant == "resident":
        ref = pallas_batch.batched_pivot_chunk(
            *map(jnp.asarray, args), interpret=True, **kw)
    else:
        ref = pallas_batch.batched_pivot_chunk_blocked(
            *map(jnp.asarray, args), interpret=True, col_block=128, **kw)
    out = batch_pivot.batched_pivot_chunk_reference(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)
    names = ("Binv", "xB", "pi", "basis", "in_basis", "gamma", "status",
             "iteration", "degen")
    got = {k: v.numpy() for k, v in zip(names, out)}
    want = {k: np.asarray(v) for k, v in zip(names, ref)}
    for k in ("basis", "in_basis", "status", "iteration", "degen"):
        assert np.array_equal(got[k], want[k]), k
    for k, tol in (("xB", 1e-4), ("pi", 1e-3), ("Binv", 1e-3), ("gamma", 1e-2)):
        scale = 1.0 + np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol * scale,
                                   err_msg=k)
    assert int(got["iteration"].sum()) > 0


@pytest.mark.parametrize(
    "shape,variant",
    [((256, 128, 384), "resident"), ((64, 128, 5120), "resident"),
     ((128, 512, 1408), "blocked"), ((64, 256, 512), "blocked"),
     ((8, 1024, 4096), "blocked"), ((8, 128, 20480), None)],
)
def test_megakernel_variant_on_hopper(shape, variant):
    """The Hopper rule: resident while one block's shared memory (232,448
    bytes) holds the inverse and the vectors, blocked while it holds the
    vectors, None beyond.  The TPU's VMEM rule called 512 x 1408 resident."""
    assert tb._megakernel_variant(shape) == variant
    _, M, N = shape
    if variant == "resident":
        assert batch_pivot.smem_bytes(M, N, resident=True) <= batch_pivot.SMEM_LIMIT
    assert jb._megakernel_variant((256, 512, 1408))[0] == "resident"


def test_megakernel_gate():
    A = torch.zeros((4, 128, 384))
    steep = jk.PRICE_STEEPEST
    assert tb.megakernel_applicable(A, "float32", "float32", steep)
    assert tb.megakernel_applicable(A, "float32", "same", steep)
    assert not tb.megakernel_applicable(A, "float64", "float32", steep)
    assert not tb.megakernel_applicable(A, "float32", "bfloat16", steep)
    assert not tb.megakernel_applicable(A, "float32", "float32", jk.PRICE_DANTZIG)
    assert not tb.megakernel_applicable(A, "float32", "float32", steep, mesh=object())
    assert not tb.megakernel_applicable(torch.zeros((4, 124, 384)), "float32", "same", steep)
    assert not tb.megakernel_applicable(torch.zeros((4, 128, 320)), "float32", "same", steep)
    assert not tb.megakernel_applicable(torch.zeros((4, 128, 20480)), "float32", "same", steep)


def test_kernel_wrappers_on_cpu_take_the_plain_version():
    A, c, cand, f = _pallas_toy(2, 32, 64)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        A, c, cand, f["Binv"], f["xB"], f["pi"], f["basis"], f["in_basis"],
        f["gamma"], f["status"], f["iteration"], f["degen_count"])]
    kw = dict(chunk=10, opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7)
    before = (batch_pivot.LAUNCHES_RESIDENT, batch_pivot.LAUNCHES_BLOCKED)
    plain = batch_pivot.batched_pivot_chunk_reference(*args, **kw)
    for fn in (batch_pivot.batched_pivot_chunk, batch_pivot.batched_pivot_chunk_blocked):
        for got, want in zip(fn(*args, **kw), plain):
            assert torch.equal(got, want)
        with pytest.raises(ValueError):
            fn(*args, noise_eps=4e-3, **kw)
        with pytest.raises(ValueError):
            fn(*args, hi_scan=True, **kw)
    assert (batch_pivot.LAUNCHES_RESIDENT, batch_pivot.LAUNCHES_BLOCKED) == before


def _cfg(jax, **kw):
    base = dict(pad_to=8, chunk_size=50, refactor_period=50)
    base.update(kw)
    return JaxConfig(**base) if jax else SolverConfig(platform="cpu", **base)


def _same_results(rj, rt):
    assert len(rj) == len(rt)
    for k, (a, b) in enumerate(zip(rj, rt)):
        assert b.status.value == a.status.value, k
        assert b.exact_objective == a.exact_objective, k
        assert b.stats.certified == a.stats.certified, k
        assert b.basis == a.basis, k
        assert b.stats.iterations == a.stats.iterations, k
        assert b.stats.phase1_iterations == a.stats.phase1_iterations, k
        assert b.stats.dual_iterations == a.stats.dual_iterations, k
        assert b.stats.batch_fallback == a.stats.batch_fallback, k


def _eq_provider(p, rhs):
    """min 2x + 3y st x + y = rhs, x - y >= 2 (needs phase 1)."""
    R = p.RangedConstraintRelation
    gf = p.GeneralForm(
        objective=p.Objective.MINIMIZE,
        constraints=p.SparseColumnMatrix.from_dense([[F(1), F(1)], [F(1), F(-1)]]),
        constraint_types=[R.equal(), R.greater()],
        b=[F(rhs), F(2)],
        variables=[p.Variable(p.VariableType.CONTINUOUS, F(2), F(0), None),
                   p.Variable(p.VariableType.CONTINUOUS, F(3), F(0), None)],
        variable_names=["x", "y"],
    )
    return gf.derive_matrix_data(gf.standardize())


def _warm_family_base(p):
    gf, counts = p.testing.scenario_base(
        WARM_FAMILY["m"], WARM_FAMILY["n"], WARM_FAMILY["seed"])
    return gf.derive_matrix_data(counts)


def _cases():
    """name -> (providers of one package, config overrides, call keywords)."""
    scen = lambda p: [p.parallel_provider(b2) for b2 in (6, 7, 8, 9)]  # noqa: E731
    mixed = lambda p: [_eq_provider(p, 10), p.parallel_provider(6),  # noqa: E731
                       _eq_provider(p, 8)]
    duals = lambda p: [p.dual_provider(b)  # noqa: E731
                       for b in ([4, 1], [4, 3], [4, 6], [5, 7])]
    intervals = lambda p: [p.interval_provider(lo)  # noqa: E731
                           for lo in ("1/2", "9/5", 3)]
    return {
        "scenarios": (scen, {}, {}),
        "scenarios-pallas_batch": (scen, dict(pad_to=128, pallas_batch=True), {}),
        "mixed_phase1": (mixed, {}, {}),
        "shared_structure": (duals, {}, dict(shared_structure=True)),
        "warm_restart": (duals, {}, dict(shared_structure=True, warm="dual")),
        "warm_restart-pallas_batch": (
            duals, dict(pad_to=128, pallas_batch=True),
            dict(shared_structure=True, warm="dual")),
        "warm_infeasible_fallback": (
            intervals, {}, dict(shared_structure=True, warm="interval")),
        # The first six scenarios of chip_smoke's warm family (+-40% rhs
        # wobbles): every scenario takes dual pivots.
        "warm_generated_family": (
            lambda p: p.testing.scenario_family(**dict(WARM_FAMILY, count=6)),
            dict(pad_to=128, chunk_size=150, refactor_period=150),
            dict(shared_structure=True, warm="generated")),
        "device_refactor": (scen, dict(chunk_size=120, refactor_period=10,
                                       device_refactor=True), {}),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_solve_batch_matches_jax(case):
    make, cfg_kw, call_kw = _cases()[case]
    call_kw = dict(call_kw)
    warm = call_kw.pop("warm", None)
    if warm is not None:
        base = {"dual": lambda p: p.dual_provider([4, 6]),
                "interval": lambda p: p.interval_provider(1),
                "generated": _warm_family_base}[warm]
        call_kw["warm_start_basis"] = jax_solve_relaxation(base(JAX), _cfg(True)).basis
        assert solve_relaxation(base(PORT), _cfg(False)).basis == call_kw["warm_start_basis"]
    rj = jax_solve_batch(make(JAX), _cfg(True, **cfg_kw), certify=True, **call_kw)
    rt = solve_batch(make(PORT), _cfg(False, **cfg_kw), certify=True, **call_kw)
    _same_results(rj, rt)
    assert all(r.stats.certified for r in rt)
    if case.startswith("warm_restart"):
        assert rt[0].stats.dual_iterations >= 1
    if case.startswith("warm"):
        assert all(r.stats.phase1_iterations == 0
                   for r in rt if not r.stats.batch_fallback)
    if case == "warm_generated_family":
        assert all(r.stats.dual_iterations > 0 for r in rt)
    if case == "warm_infeasible_fallback":
        assert rt[2].status is SolveStatus.INFEASIBLE and rt[2].stats.batch_fallback


def test_generated_family_matches_jax():
    """Eight rhs-perturbed scenarios of the generated LP (m=16, n=48), f32
    steepest edge, shared structure, every LP certified in both packages."""
    kw = dict(pad_to=128, chunk_size=150, refactor_period=150)
    rj = jax_solve_batch(JAX.testing.scenario_family(16, 48, 7, 8), JaxConfig(**kw),
                         certify=True, shared_structure=True)
    rt = solve_batch(scenario_family(16, 48, 7, 8),
                     SolverConfig(platform="cpu", **kw),
                     certify=True, shared_structure=True)
    _same_results(rj, rt)
    assert all(r.status is SolveStatus.FINITE_OPTIMUM and r.stats.certified
               for r in rt)
    assert len({r.exact_objective for r in rt}) > 1  # the scenarios differ


def test_solve_batch_takes_the_kernel_path_by_default(monkeypatch):
    """With the default config (pallas_batch False) the cold phases of a
    batch the gate takes run through megakernel_run_chunk, and a config
    asking for pallas_batch gives the same results."""
    from relp_tpu_torch.parallel import batch_driver

    calls = []
    kept = batch_driver.megakernel_run_chunk

    def counted(*args, **kwargs):
        calls.append(kwargs["stop_at_zero"])
        return kept(*args, **kwargs)

    monkeypatch.setattr(batch_driver, "megakernel_run_chunk", counted)
    kw = dict(platform="cpu", pad_to=128, chunk_size=150, refactor_period=150)
    runs = [solve_batch(scenario_family(16, 48, 7, 4), SolverConfig(**kw, **extra),
                        certify=True, shared_structure=True)
            for extra in ({}, dict(pallas_batch=True))]
    assert True in calls and False in calls  # phase 1 and phase 2
    _same_results(*runs)


def test_mesh_raises():
    """A mesh that does not hold the world raises ValueError; a world of one
    (gloo, in this process) solves the batch as the unsharded port does."""
    from relp_tpu_torch.parallel import make_mesh
    from tests.test_torch_mesh import world_of_one

    providers = lambda: [PORT.parallel_provider(b2) for b2 in (6, 7)]  # noqa: E731
    plain = solve_batch(providers(), _cfg(False))
    with world_of_one() as mesh:
        with pytest.raises(ValueError):
            make_mesh((1, 2))
        sharded = solve_batch(providers(), _cfg(False), mesh=mesh)
    for rp, rs in zip(plain, sharded):
        assert (rs.status, rs.exact_objective, rs.basis, rs.stats.iterations) == (
            rp.status, rp.exact_objective, rp.basis, rp.stats.iterations)


def test_pallas_batch_on_a_shape_no_kernel_takes_runs_the_torch_path(caplog):
    """pallas_batch with a shape the gate refuses (N % 128 != 0 at pad_to=8)
    runs the batched torch path and says so at INFO."""
    import logging

    before = (batch_pivot.LAUNCHES_RESIDENT, batch_pivot.LAUNCHES_BLOCKED)
    with caplog.at_level(logging.INFO, logger="relp_tpu_torch"):
        rt = solve_batch([PORT.parallel_provider(6)],
                         dataclasses.replace(_cfg(False), pallas_batch=True))
    assert rt[0].exact_objective == -F(14, 5)
    assert "batched torch path" in caplog.text
    assert (batch_pivot.LAUNCHES_RESIDENT, batch_pivot.LAUNCHES_BLOCKED) == before


def _family_start(m, n, count, shared):
    """A generated family on the CPU at its phase-1 start, as solve_batch
    lowers it, with fresh steepest-edge weights."""
    from relp_tpu_torch.parallel.batch_driver import lower_batch

    cfg = SolverConfig(platform="cpu", pad_to=128, chunk_size=150,
                       refactor_period=150)
    _p, A, _b, c1, _c2, cand, st = lower_batch(
        scenario_family(m, n, 7, count), cfg, torch.device("cpu"),
        shared_structure=shared)
    return A, c1, cand, st._replace(gamma=tb._v_gamma(st.Binv, A, st.in_basis))


def test_lower_batch_shares_one_tableau():
    """shared_structure=True hands out one (M, N) tableau expanded over the
    batch (stride 0, M N elements of storage); without it, B copies."""
    A, *_ = _family_start(16, 48, 5, shared=True)
    B, M, N = A.shape
    assert A.stride() == (0, N, 1)
    assert A.untyped_storage().nbytes() == M * N * A.element_size()
    assert batch_pivot.a_batch_stride(A) == 0
    with pytest.raises(RuntimeError):
        A.add_(1.0)  # nothing may write into the shared tableau
    stacked, *_ = _family_start(16, 48, 5, shared=False)
    assert stacked.is_contiguous() and torch.equal(stacked, A)
    assert batch_pivot.a_batch_stride(stacked) == M * N


def test_a_batch_stride_takes_two_layouts_only():
    base = torch.zeros(8, 12)
    assert batch_pivot.a_batch_stride(base.expand(3, 8, 12)) == 0
    assert batch_pivot.a_batch_stride(torch.zeros(3, 8, 12)) == 96
    assert batch_pivot.a_batch_stride(base.unsqueeze(0)) == 96  # B = 1
    for bad in (torch.zeros(3, 12, 8).transpose(1, 2),  # column-major rows
                torch.zeros(6, 8, 12)[::2],  # every other tableau
                torch.zeros(3, 8, 16)[:, :, :12],  # padded rows
                torch.zeros(8, 12)):  # no batch dimension
        with pytest.raises(ValueError):
            batch_pivot.a_batch_stride(bad)


def test_cast_tableau_keeps_one_tableau():
    from relp_tpu_torch.parallel.batch_driver import cast_tableau

    A = torch.ones(4, 6, dtype=torch.float64).expand(3, 4, 6)
    cast = cast_tableau(A, torch.float32)
    assert cast.dtype == torch.float32 and cast.stride() == (0, 6, 1)
    assert cast.untyped_storage().nbytes() == 4 * 6 * 4
    stacked = cast_tableau(torch.ones(3, 4, 6, dtype=torch.float64), torch.float32)
    assert stacked.is_contiguous() and torch.equal(stacked, cast)


@pytest.mark.parametrize("stop_at_zero", [True, False])
def test_plain_version_on_the_shared_tableau_equals_stacked_copies(stop_at_zero):
    """The kernels' plain version gives the same bits on the expanded view
    as on B stacked copies (f32, from the family's phase-1 start)."""
    A, c1, cand, st = _family_start(16, 48, 4, shared=True)
    kw = dict(chunk=25, opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7,
              stop_at_zero=stop_at_zero)
    state = (st.Binv, st.xB, st.pi, st.basis, st.in_basis, st.gamma,
             st.status, st.iteration, st.degen_count)
    shared = batch_pivot.batched_pivot_chunk_reference(A, c1, cand, *state, **kw)
    copies = batch_pivot.batched_pivot_chunk_reference(
        A.contiguous(), c1, cand, *state, **kw)
    for got, want in zip(shared, copies):
        assert torch.equal(got, want)
    assert int((shared[7] - st.iteration).min()) > 0


def test_solve_batch_on_the_shared_tableau_equals_stacked_copies():
    """solve_batch with shared_structure (one expanded tableau) and without
    it (B copies) reach the same results on a generated family."""
    kw = dict(platform="cpu", pad_to=128, chunk_size=150, refactor_period=150)
    runs = [solve_batch(scenario_family(16, 48, 7, 4), SolverConfig(**kw),
                        certify=True, shared_structure=shared)
            for shared in (True, False)]
    _same_results(*runs)
    assert all(r.stats.certified and not r.stats.batch_fallback for r in runs[0])


@pytest.mark.parametrize("M,N,resident,blocked,rows", [
    (128, 384, 80_672, 117_024, 128),  # the resident family
    (512, 1408, 1_093_408, 231_200, 45),  # the blocked family
    (224, 544, 220_512, 231_904, 108),
    (128, 20480, 362_016, 393_760, None),
])
def test_shared_memory_formula(M, N, resident, blocked, rows):
    """Bytes per block of each variant (csrc/batch_pivot.cu smem_bytes) and
    the inverse rows the blocked kernel keeps in shared memory: at 128 x 384
    two resident blocks fit one SM's 228 KB."""
    assert batch_pivot.smem_bytes(M, N, resident=True) == resident
    assert batch_pivot.smem_bytes(M, N, resident=False) == blocked
    assert batch_pivot.blocked_rows(M, N) == rows
