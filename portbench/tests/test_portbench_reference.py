"""The generators and the plain reference: the same data from the same
seed, and the reference against the port (and HiGHS, where scipy has it) on
the CPU at tiny sizes."""

import json
import random
from fractions import Fraction

import numpy as np
import pytest

from portbench.gen import mknap
from portbench.problems import mknap as problem
from portbench.reference import lp as ref
from portbench.reference import mknap as ref_mknap
from portbench.tests.conftest import PORTBENCH, TINY

MKNAP = json.loads((PORTBENCH / "configs" / "mknapcb1.json").read_text())
MKNAP9 = json.loads((PORTBENCH / "configs" / "mknapcb9.json").read_text())
BIG_SEED = 2**31 + 2**40 + 5


def test_the_stream_configuration_has_the_published_class():
    W, capacity, profit = problem.draw(MKNAP9, 1, 0)
    assert W.shape == (30, 500) and W.min() >= 1 and W.max() <= 1000
    assert np.array_equal(capacity, np.floor(0.25 * W.sum(axis=1)))
    extra = profit - W.sum(axis=0) // 30
    assert extra.min() >= 0 and extra.max() <= 500


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED, -3])
def test_the_stream_draws_the_same_lp_from_the_same_seed(seed):
    a, b, c = (problem.draw(MKNAP9, seed, i) for i in (3, 3, 4))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_the_knapsack_copy_draws_what_the_programs_helper_draws():
    from relp_tpu_torch.testing import mknap_data

    for seed in (7, 12345):
        for got, want in zip(mknap.instance(MKNAP, seed),
                             mknap_data(m=5, n=100, tightness=0.25, seed=seed)):
            assert np.array_equal(got, want)
    W, _c, _p = mknap.instance(MKNAP, BIG_SEED, 2)
    assert np.array_equal(W, mknap.instance(MKNAP, BIG_SEED, 2)[0])
    assert not np.array_equal(W, mknap.instance(MKNAP, BIG_SEED, 3)[0])


def _rational_system(rng, m):
    rows = []
    for i in range(m):
        row = {i: Fraction(rng.randint(1, 5))}
        for _ in range(2):
            row[rng.randrange(m)] = Fraction(rng.randint(-3, 3), rng.randint(1, 4)) or 1
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", range(5))
def test_the_exact_sparse_solve_solves(seed):
    rng = random.Random(seed)
    rows = _rational_system(rng, 12)
    b = [Fraction(rng.randint(-9, 9)) for _ in range(12)]
    try:
        x, = ref._solve(rows, [b])
    except ZeroDivisionError:
        pytest.skip("a singular draw")
    for i, row in enumerate(rows):
        assert sum(v * x[k] for k, v in row.items()) == b[i]


def test_infeasible_and_unbounded_lps_are_proven():
    # x1 + x2 = -1 with x >= 0: infeasible.
    lp = ref.LP([[(0, 1)], [(0, 1)]], [-1], [0, 0])
    assert ref.solve(lp).status == ref.INFEASIBLE
    # minimise -x1 with x1 - x2 = 0: unbounded.
    lp = ref.LP([[(0, 1)], [(0, -1)]], [0], [-1, 0])
    assert ref.solve(lp).status == ref.UNBOUNDED


TINY9 = dict(MKNAP9, **TINY["mknapcb9"])


@pytest.mark.parametrize("index", range(3))
def test_the_reference_agrees_with_the_port_on_knapsack_relaxations(index):
    from relp_tpu_torch import SolverConfig
    from relp_tpu_torch.simplex import solve_general_form

    data = problem.draw(TINY9, 99, index)
    want = ref.solve(problem.reference_lp(data))
    result, solution = solve_general_form(problem.model(data), SolverConfig(platform="cpu"))
    assert result.stats.certified and solution.objective_value == want.objective
    assert want.objective.denominator > 1
    values = dict(solution.solution_values)
    assert problem.point_holds(data, values, want.objective)
    assert not problem.point_holds(data, values, want.objective - 1)
    assert ref.check_point(problem.reference_lp(data), want.x)


@pytest.mark.parametrize("index", range(3))
def test_the_reference_agrees_with_highs_on_knapsack_relaxations(index):
    so = pytest.importorskip("scipy.optimize")
    lp = problem.reference_lp(problem.draw(TINY9, 5, index))
    A = np.zeros((len(lp.b), len(lp.columns)))
    for j, col in enumerate(lp.columns):
        for i, v in col:
            A[i, j] = v
    res = so.linprog(lp.c, A_eq=A, b_eq=lp.b, method="highs")
    assert abs(float(ref.solve(lp).objective) - res.fun) <= 1e-9 * max(1, abs(res.fun))


def test_the_reference_agrees_with_the_port_on_the_knapsack_relaxation():
    from relp_tpu_torch import SolverConfig
    from relp_tpu_torch.mip import solve_mip

    cfg = dict(MKNAP, **TINY["mknapcb1"])
    W, capacity, profit = data = mknap.instance(cfg, 3)
    relax = ref.solve(ref_mknap.relaxation(W, capacity, profit))
    mip = solve_mip(problem.model(data, integer=True),
                    SolverConfig(platform="cpu", dtype="float64"), batch_width=4)
    assert mip.certified and mip.best_bound == mip.objective
    assert relax.objective <= mip.objective
    assert ref_mknap.point_holds(W, capacity, profit, dict(mip.solution.solution_values),
                                 mip.objective)
    assert not ref_mknap.point_holds(W, capacity, profit,
                                     dict(mip.solution.solution_values),
                                     mip.objective + 1)


@pytest.mark.parametrize("precision", ["tf32", "float32"])
def test_the_control_answers_in_floating_point(precision):
    lp = problem.reference_lp(problem.draw(dict(MKNAP9, m=10, n=60), 11, 0))
    exact, control = ref.solve(lp), ref.solve(lp, precision=precision, exact=False)
    assert control.status == exact.status
    assert control.objective != exact.objective
    assert abs(control.float_objective - float(exact.objective)) < 1e-2 * abs(
        float(exact.objective))
