"""The port's driver against the JAX package's, end to end on the CPU.

Every LP case of tests/test_simplex_small.py, problem_1 and problem_2 of
tests/test_pipeline_problem1.py, 30 seeds of the fuzz generator of
tests/test_fuzz_differential.py and the generated LP of
relp_tpu_torch.testing at m=64, n=256 go through both packages, at f32 and
f64, each package building the input with its own classes from the same
source (``twin``).  The exact verdict must agree: the same SolveStatus
value, the same ``certified`` and the same Fraction objective (exact, no
tolerance).
"""

import importlib
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest

import relp_tpu_torch.testing
from relp_tpu.config import SolverConfig as JaxConfig
from relp_tpu.data import network as jax_network
from relp_tpu.io import mps_to_general_form as jax_mps_to_general_form
from relp_tpu.io import parse_free as jax_parse_free
from relp_tpu.simplex import solve_general_form as jax_solve_general_form
from relp_tpu.simplex import solve_relaxation as jax_solve_relaxation
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.data import network
from relp_tpu_torch.io import mps_to_general_form, parse_free
from relp_tpu_torch.simplex import SolveStatus, solve_general_form, solve_relaxation
from tests.test_pipeline_problem1 import MPS_LITERAL
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_host_copy import twin


def _package(port: bool) -> SimpleNamespace:
    """One package's builders of the test inputs."""
    def pick(name):
        return twin(name) if port else importlib.import_module(name)

    small = pick("tests.test_simplex_small")
    return SimpleNamespace(
        gf=small._gf, O=small.Objective, R=small.RangedConstraintRelation,
        random_instance=pick("tests.test_fuzz_differential")._random_instance,
        problem_2=pick("tests.test_pipeline_problem1")._problem_2_matrix_data,
        problem_1=lambda: (mps_to_general_form(parse_free(MPS_LITERAL)) if port
                           else jax_mps_to_general_form(jax_parse_free(MPS_LITERAL))),
        MaxFlowPrimal=(network if port else jax_network).MaxFlowPrimal,
        testing=(relp_tpu_torch.testing if port
                 else twin("relp_tpu_torch.testing", "relp_tpu")),
    )


JAX, PORT = _package(False), _package(True)

DTYPES = ("float32", "float64")
SMALL = dict(pad_to=8, chunk_size=50, refactor_period=50)  # conftest cpu_config
TIGHT = dict(pad_to=8, presolve=False)

# name -> (GeneralForm factory, config overrides); the LP cases of
# tests/test_simplex_small.py.
SIMPLEX_SMALL = {
    "basic_max_lp": (lambda p: p.gf(
        p.O.MAXIMIZE, [[1, 2], [3, 1]], [p.R.less(), p.R.less()], [4, 6],
        [1, 1], [(0, None), (0, None)]), SMALL),
    "equality_and_ge": (lambda p: p.gf(
        p.O.MINIMIZE, [[1, 1], [1, -1]], [p.R.equal(), p.R.greater()],
        [10, 2], [2, 3], [(0, None), (0, None)]), SMALL),
    "free_variable_split": (lambda p: p.gf(
        p.O.MINIMIZE, [[1, 1], [1, -1]], [p.R.greater(), p.R.greater()],
        [3, -1], [1, 1], [(0, None), (None, None)]), SMALL),
    "unbounded": (lambda p: p.gf(
        p.O.MINIMIZE, [[1, -1]], [p.R.less()], [1], [-1, 0],
        [(0, None), (0, None)]), SMALL),
    "infeasible": (lambda p: p.gf(
        p.O.MINIMIZE, [[1, 1], [1, 1]], [p.R.less(), p.R.greater()], [1, 3],
        [1, 1], [(0, None), (0, None)]), TIGHT),
    "upper_bounded_variables": (lambda p: p.gf(
        p.O.MAXIMIZE, [[1, 1]], [p.R.less()], [4], [3, 2],
        [(0, 2), (0, 3)]), SMALL),
    "range_constraint": (lambda p: p.gf(
        p.O.MINIMIZE, [[1, 1]], [p.R.ranged(Fraction(3))], [5], [1, 1],
        [(0, None), (0, None)]), SMALL),
    "redundant_rows_rank_repair": (lambda p: p.gf(
        p.O.MINIMIZE, [[1, 1], [1, 1], [1, -1]],
        [p.R.equal(), p.R.equal(), p.R.equal()], [4, 4, 0], [1, 2],
        [(0, None), (0, None)]), TIGHT),
    "degenerate_lp": (lambda p: p.gf(
        p.O.MINIMIZE, [[1, 1, 1], [1, 0, 0], [0, 1, 0]],
        [p.R.less(), p.R.less(), p.R.less()], [2, 1, 1], [-1, -1, -1],
        [(0, None), (0, None), (0, None)]), SMALL),
    "unbounded_is_exactly_certified": (lambda p: p.gf(
        p.O.MINIMIZE, [[1, -1]], [p.R.less()], [1], [-1, 0],
        [(0, None), (0, None)]), TIGHT),
    "debug_validate_runs_clean": (lambda p: p.gf(
        p.O.MINIMIZE, [[1, 2], [3, 1], [1, 1]],
        [p.R.greater(), p.R.less(), p.R.equal()], [2, 9, 3], [2, 3],
        [(0, None), (0, None)]),
        dict(SMALL, debug_validate=True, chunk_size=2, refactor_period=2)),
    "problem_1": (lambda p: p.problem_1(), dict(pad_to=8, pricing="first")),
    "generated_64x256": (lambda p: p.testing.generated_lp(64, 256, 7), {}),
}


def _verdict(result, solution):
    objective = solution.objective_value if solution is not None else None
    return result.status.value, result.stats.certified, objective


def _both(build, overrides, dtype):
    jax_out = jax_solve_general_form(build(JAX), JaxConfig(dtype=dtype, **overrides))
    port_out = solve_general_form(
        build(PORT), SolverConfig(dtype=dtype, platform="cpu", **overrides)
    )
    return _verdict(*jax_out), _verdict(*port_out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(SIMPLEX_SMALL))
def test_general_form_cases_match_jax(name, dtype):
    build, overrides = SIMPLEX_SMALL[name]
    jax_verdict, port_verdict = _both(build, overrides, dtype)
    assert port_verdict == jax_verdict


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(30))
def test_fuzz_instances_match_jax(seed, dtype):
    build = lambda p: p.random_instance(np.random.default_rng(seed))[0]  # noqa: E731
    jax_verdict, port_verdict = _both(build, dict(pad_to=8), dtype)
    assert port_verdict == jax_verdict


def _relaxation_verdict(result):
    return (result.status.value, result.stats.certified, result.exact_objective,
            result.stats.phase1_iterations == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["problem_2", "full_initial_basis", "max_flow"])
def test_relaxation_cases_match_jax(case, dtype):
    """solve_relaxation on providers built directly (no GeneralForm)."""

    def provider(p):
        if case == "problem_2":
            return p.problem_2()
        if case == "max_flow":  # the network of examples/max_flow.py
            F = Fraction
            return p.MaxFlowPrimal(
                [[F(0)] * 4, [F(3), F(0), F(0), F(0)],
                 [F(2), F(1), F(0), F(0)], [F(0), F(2), F(2), F(0)]], s=0, t=3)
        gf = p.gf(p.O.MINIMIZE, [[1, 2], [3, 1]], [p.R.less(), p.R.less()],
                  [4, 6], [-1, -1], [(0, None), (0, None)])
        return gf.derive_matrix_data(gf.standardize())

    overrides = dict(pad_to=8, pricing="first" if case == "problem_2" else "steepest")
    jax_result = jax_solve_relaxation(provider(JAX), JaxConfig(dtype=dtype, **overrides))
    port_result = solve_relaxation(
        provider(PORT), SolverConfig(dtype=dtype, platform="cpu", **overrides)
    )
    assert _relaxation_verdict(port_result) == _relaxation_verdict(jax_result)
    assert port_result.stats.certified
    assert dict(port_result.exact_bfs.entries) == dict(jax_result.exact_bfs.entries)


def test_cuda_is_never_a_silent_fallback():
    """platform=None means CUDA: without a card the port raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_general_form(SIMPLEX_SMALL["basic_max_lp"][0](PORT), SolverConfig(pad_to=8))


@pytest.mark.parametrize(
    "overrides, match",
    [(dict(carry="df32"), "DoubleFloatEngine")],
)
def test_unported_options_raise(overrides, match):
    with pytest.raises(NotImplementedError, match=match):
        solve_general_form(
            SIMPLEX_SMALL["basic_max_lp"][0](PORT),
            SolverConfig(pad_to=8, platform="cpu", presolve=False, **overrides),
        )


def test_mesh_raises():
    gf = SIMPLEX_SMALL["basic_max_lp"][0](PORT)
    data = gf.derive_matrix_data(gf.standardize())
    with pytest.raises(NotImplementedError, match="mesh"):
        solve_relaxation(data, SolverConfig(pad_to=8, platform="cpu"), mesh=object())


def test_warm_start_and_dual_restart_match_jax():
    """Warm start from the optimal basis of min -x-y, x+2y <= 4, 3x+y <= 6
    after the second right-hand side changes: still primal feasible (3, 11)
    or only dual feasible (1, 14, the dual restart path)."""

    def provider(p, b2):
        gf = p.gf(p.O.MINIMIZE, [[1, 2], [3, 1]], [p.R.less(), p.R.less()],
                  [4, b2], [-1, -1], [(0, None), (0, None)])
        return gf.derive_matrix_data(gf.standardize())

    cfg_j, cfg_t = JaxConfig(pad_to=8), SolverConfig(pad_to=8, platform="cpu")
    basis = jax_solve_relaxation(provider(JAX, 6), cfg_j).basis
    dual_pivots = 0
    for b2 in (3, 11, 1, 14):
        jr = jax_solve_relaxation(provider(JAX, b2), cfg_j, warm_start_basis=basis)
        tr = solve_relaxation(provider(PORT, b2), cfg_t, warm_start_basis=basis)
        assert tr.status is SolveStatus.FINITE_OPTIMUM and tr.stats.certified
        assert tr.exact_objective == jr.exact_objective
        assert tr.stats.dual_iterations == jr.stats.dual_iterations
        assert tr.stats.phase1_iterations == jr.stats.phase1_iterations
        dual_pivots += tr.stats.dual_iterations
    assert dual_pivots > 0
