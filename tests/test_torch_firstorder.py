"""The port's restarted PDHG, its crossover finish and the sparse host
backend against the JAX package's, on the CPU.

* ``ruiz_equilibrate`` is host numpy in both packages: bit-equal.
* ``pdhg_solve`` in f64 on the tiny and box cases of tests/test_firstorder.py
  and its 13x37 random LP: the same iteration and restart counts, the same
  ``converged``, and x, y within 1e-9 relative to 1 + max|field|.  The two
  packages sum the matvecs in different orders, so the iterates differ by
  rounding that the restart tests (which compare residuals) could amplify
  into another restart; these cases keep every restart decision clear.
* ``solve_first_order`` with crossover (f32 and f64): the same exact
  verdict and Fraction objective on problem_1, problem_2 and fuzz
  instances; in f64 also the same PDHG iteration count.  Without
  crossover, the lifted x, y and statistics.
* ``backend="host_sparse"``: the same exact verdict and Fraction objective
  on the driver-test cases and fuzz instances; "auto" picks it only when
  the solve runs on the CPU.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from relp_tpu.config import SolverConfig as JaxConfig
from relp_tpu.firstorder import pdhg as jax_pdhg
from relp_tpu.firstorder import solve_first_order as jax_solve_first_order
from relp_tpu.simplex import solve_general_form as jax_solve_general_form
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.firstorder import pdhg, solve_first_order
from relp_tpu_torch.simplex import solve_general_form
from relp_tpu_torch.simplex.host_sparse import should_use_host_sparse
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_driver import JAX, PORT, SIMPLEX_SMALL, _verdict

DTYPES = ("float32", "float64")


def _random_lp():
    """tests/test_firstorder.py's 13x37 LP (feasible, a third of the columns
    boxed)."""
    rng = np.random.default_rng(7)
    m, n = 13, 37
    A = np.abs(rng.standard_normal((m, n))) + 0.1
    b = A @ np.abs(rng.standard_normal(n))
    c = rng.standard_normal(n)
    u = np.full(n, np.inf)
    u[::3] = np.abs(rng.standard_normal((n + 2) // 3)) + 1.0
    return A, b, c, u


PDHG_CASES = {
    # min -x-y st x+2y<=4, 3x+y<=6 (slacks as columns): optimum (8/5, 6/5)
    "tiny": (np.array([[1.0, 2.0, 1.0, 0.0], [3.0, 1.0, 0.0, 1.0]]),
             np.array([4.0, 6.0]), np.array([-1.0, -1.0, 0.0, 0.0]), None),
    # min -x st x + s = 5, x <= 3 by the box
    "box": (np.array([[1.0, 1.0]]), np.array([5.0]), np.array([-1.0, 0.0]),
            np.array([3.0, np.inf])),
    "random_13x37": _random_lp(),
}


def _close(mine, want, tol):
    scale = 1.0 + float(np.abs(want).max(initial=0.0))
    return float(np.abs(mine - want).max(initial=0.0)) <= tol * scale


def test_ruiz_equilibrate_is_bit_equal():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((7, 11)) * np.exp(rng.uniform(-6, 6, (7, 11)))
    A[2] = 0.0  # an empty row keeps its unit scale
    for mine, want in zip(pdhg.ruiz_equilibrate(A), jax_pdhg.ruiz_equilibrate(A)):
        assert np.array_equal(mine, want)


@pytest.mark.parametrize("name", sorted(PDHG_CASES))
def test_pdhg_solve_matches_jax(name):
    A, b, c, u = PDHG_CASES[name]
    kw = dict(tol=1e-9, dtype=np.float64)
    xj, yj, sj = jax_pdhg.pdhg_solve(A, b, c, u, **kw)
    xt, yt, st = pdhg.pdhg_solve(A, b, c, u, device="cpu", **kw)
    assert sj.converged and st.converged
    assert (st.iterations, st.restarts) == (sj.iterations, sj.restarts)
    assert _close(xt, xj, 1e-9) and _close(yt, yj, 1e-9)
    for field in ("primal_residual", "dual_residual", "gap"):
        assert getattr(st, field) <= 1e-9


@pytest.mark.parametrize("name", sorted(PDHG_CASES))
def test_host_kkt_matches_the_ports(name):
    """tools.pdhg_check.kkt64 (numpy, chip_smoke's host evaluation) against
    the port's torch _kkt in f64 at an unconverged point (200 iterations)."""
    from relp_tpu_torch.tools.pdhg_check import kkt64

    A, b, c, u = PDHG_CASES[name]
    u = np.full(A.shape[1], np.inf) if u is None else u
    x, y, _st = pdhg.pdhg_solve(A, b, c, u, tol=0.0, max_iters=200,
                                dtype=np.float64, device="cpu")
    port = pdhg._kkt(*(torch.as_tensor(v, dtype=torch.float64) for v in (A, b, c, u, x, y)))
    host = kkt64(A, b, c, u, x, y)
    assert max(host) > 0.0
    for h, p in zip(host, port):
        assert abs(h - p) <= 1e-12 * (1.0 + abs(h))


def test_pdhg_f32_converges_to_the_same_point():
    """f32 iterates: both packages converge at tol 1e-4 to the same vertex."""
    A, b, c, u = PDHG_CASES["random_13x37"]
    kw = dict(tol=1e-4, dtype=np.float32)
    xj, _yj, sj = jax_pdhg.pdhg_solve(A, b, c, u, **kw)
    xt, _yt, st = pdhg.pdhg_solve(A, b, c, u, device="cpu", **kw)
    assert sj.converged and st.converged
    assert _close(xt, xj, 1e-3)


def test_pdhg_runs_on_cuda_by_default():
    """device=None means CUDA: without a card a direct call raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    A, b, c, u = PDHG_CASES["tiny"]
    with pytest.raises(RuntimeError, match="cuda"):
        pdhg.pdhg_solve(A, b, c, u)
    gf = SIMPLEX_SMALL["basic_max_lp"][0](PORT)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_first_order(gf.derive_matrix_data(gf.standardize()), SolverConfig())


def test_mesh_raises():
    """A mesh that does not hold the world raises ValueError; a world of one
    (gloo, in this process) runs pdhg_solve and solve_first_order as the
    unsharded port does."""
    from relp_tpu_torch.parallel import make_mesh
    from tests.test_torch_mesh import world_of_one

    A, b, c, u = PDHG_CASES["tiny"]
    gf = SIMPLEX_SMALL["basic_max_lp"][0](PORT)
    data = gf.derive_matrix_data(gf.standardize())
    cfg = SolverConfig(platform="cpu", dtype="float64")
    x0, y0, s0 = pdhg.pdhg_solve(A, b, c, u, device="cpu", dtype=np.float64)
    plain = solve_first_order(data, cfg)
    with world_of_one() as mesh:
        with pytest.raises(ValueError):
            make_mesh((2, 1))
        x1, y1, s1 = pdhg.pdhg_solve(A, b, c, u, device="cpu", dtype=np.float64,
                                     mesh=mesh)
        sharded = solve_first_order(data, cfg, mesh=mesh)
    assert s1.iterations == s0.iterations and s1.converged == s0.converged
    assert _close(x1, x0, 1e-9) and _close(y1, y0, 1e-9)
    assert sharded.exact_objective == plain.exact_objective
    assert sharded.stats.certified


def _provider(p, case):
    """One package's matrix data of a first-order case."""
    if case == "problem_2":
        return p.problem_2()
    if case == "problem_1":
        gf = p.problem_1()
        gf.presolve()
    else:  # fuzz<seed>
        gf = p.random_instance(np.random.default_rng(int(case[4:])))[0]
    return gf.derive_matrix_data(gf.standardize())


FO_CASES = ["problem_1", "problem_2"] + [f"fuzz{s}" for s in (0, 1, 3, 4, 9)]
FO = dict(tol=1e-6, max_iters=4_000)


def _fo_verdict(result):
    return (result.status.value, result.stats.certified, result.exact_objective)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FO_CASES)
def test_solve_first_order_matches_jax(case, dtype):
    jr = jax_solve_first_order(_provider(JAX, case), JaxConfig(dtype=dtype, pad_to=8), **FO)
    tr = solve_first_order(_provider(PORT, case),
                           SolverConfig(dtype=dtype, pad_to=8, platform="cpu"), **FO)
    assert _fo_verdict(tr) == _fo_verdict(jr)
    if dtype == "float64":
        assert tr.stats.first_order_iterations == jr.stats.first_order_iterations
    assert tr.first_order_stats.iterations == tr.stats.first_order_iterations


@pytest.mark.parametrize("case", ["problem_1", "problem_2"])
def test_first_order_without_crossover_matches_jax(case):
    kw = dict(tol=1e-8, max_iters=20_000, crossover=False)
    xj, yj, sj = jax_solve_first_order(_provider(JAX, case), JaxConfig(dtype="float64"), **kw)
    xt, yt, st = solve_first_order(_provider(PORT, case),
                                   SolverConfig(dtype="float64", platform="cpu"), **kw)
    assert (st.iterations, st.restarts, st.converged) == (
        sj.iterations, sj.restarts, sj.converged)
    assert xt.shape == xj.shape and yt.shape == yj.shape
    assert _close(xt, xj, 1e-9) and _close(yt, yj, 1e-9)


HOST_SPARSE = dict(backend="host_sparse")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(SIMPLEX_SMALL))
def test_host_sparse_cases_match_jax(name, dtype):
    build, overrides = SIMPLEX_SMALL[name]
    options = dict(overrides, dtype=dtype, **HOST_SPARSE)
    jax_out = jax_solve_general_form(build(JAX), JaxConfig(**options))
    port_out = solve_general_form(build(PORT), SolverConfig(platform="cpu", **options))
    assert _verdict(*port_out) == _verdict(*jax_out)


@pytest.mark.parametrize("phase1", ["two_phase", "bigm"])
@pytest.mark.parametrize("seed", range(8))
def test_host_sparse_fuzz_instances_match_jax(seed, phase1):
    build = lambda p: p.random_instance(np.random.default_rng(seed))[0]  # noqa: E731
    options = dict(pad_to=8, phase1=phase1, **HOST_SPARSE)
    jax_out = jax_solve_general_form(build(JAX), JaxConfig(**options))
    port_out = solve_general_form(build(PORT), SolverConfig(platform="cpu", **options))
    assert _verdict(*port_out) == _verdict(*jax_out)


def _stub_provider(m, n, nnz_per_column):
    """The four provider calls the routing rule makes."""
    column = SimpleNamespace(entries=lambda: [None] * nnz_per_column)
    return SimpleNamespace(nr_rows=lambda: m, nr_columns=lambda: n,
                           column=lambda j: column)


def test_auto_routes_to_host_sparse_only_on_the_cpu():
    """The JAX package's size rule (>= 2.5e7 padded cells, < 2% dense),
    asked of the solve's torch device: the CPU may take the host backend,
    CUDA never does."""
    cfg = SolverConfig(platform="cpu")
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    huge_sparse = _stub_provider(1000, 24_000, 2)
    assert should_use_host_sparse(huge_sparse, cfg, cpu)
    assert not should_use_host_sparse(huge_sparse, cfg, cuda)
    assert not should_use_host_sparse(_stub_provider(1000, 24_000, 40), cfg, cpu)
    assert not should_use_host_sparse(_stub_provider(100, 2_000, 2), cfg, cpu)


class _RaisingProvider:
    """A 5000 x 5000 provider whose columns raise ValueError; it records
    every attribute asked of it, so a test can tell that no array was
    built."""

    def __init__(self):
        self.asked = []

    def __getattr__(self, name):
        self.asked.append(name)
        if name in ("nr_rows", "nr_columns"):
            return lambda: 5000
        if name == "column":
            def column(j):
                raise ValueError(f"column {j} cannot be read")
            return column
        raise AttributeError(name)


def test_auto_route_stays_dense_when_columns_raise():
    """should_use_host_sparse catches any error of an unknown provider, as
    the JAX package does (``except Exception``): both packages return
    False, and neither builds an array."""
    from relp_tpu.config import SolverConfig as JaxCfg
    from relp_tpu.simplex.host_sparse import should_use_host_sparse as jax_rule

    port_provider, jax_provider = _RaisingProvider(), _RaisingProvider()
    assert not should_use_host_sparse(
        port_provider, SolverConfig(platform="cpu"), torch.device("cpu"))
    assert not jax_rule(jax_provider, JaxCfg())
    for provider in (port_provider, jax_provider):
        assert set(provider.asked) == {"nr_rows", "nr_columns", "column"}
