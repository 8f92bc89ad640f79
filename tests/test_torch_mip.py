"""The port's exact branch & bound against the JAX package's, on the CPU.

The cases of tests/test_mip.py that need no mount and no mesh go through
``solve_mip`` of both packages at f32 and f64, each package building the
GeneralForm with its own classes from the same source (``twin`` of
tests/test_mip.py's ``_gf``).  Both must give the same status, Fraction
objective, best_bound, gap, certified and root objective; in f64 also the
same node counts (solved and pruned) and dive LPs.  Exact arithmetic decides
every bound and pruning comparison, so there is no tolerance.
"""

import importlib
from fractions import Fraction

import pytest

from relp_tpu.config import SolverConfig as JaxConfig
from relp_tpu.mip import solve_mip as jax_solve_mip
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.mip import solve_mip
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_host_copy import twin

JAX_MIP = importlib.import_module("tests.test_mip")
PORT_MIP = twin("tests.test_mip")
DTYPES = ("float32", "float64")
SMALL = dict(pad_to=8, chunk_size=50, refactor_period=50)  # tests/test_mip.py _cfg


def _two_var(m):
    """max 5x+4y s.t. 6x+4y<=24, x+2y<=6, x in [0,4], y in [0,3] integers."""
    R, I = m.RangedConstraintRelation, m.VariableType.INTEGER
    return m._gf(m.Objective.MAXIMIZE, [[6, 4], [1, 2]], [R.less(), R.less()],
                 [24, 6], [5, 4], [(0, 4), (0, 3)], [I, I], names=["x", "y"])


def _knapsack(m):
    R, I = m.RangedConstraintRelation, m.VariableType.INTEGER
    return m._gf(m.Objective.MAXIMIZE, [[5, 7, 4, 3, 6, 5]], [R.less()], [14],
                 [10, 13, 7, 8, 12, 9], [(0, 1)] * 6, [I] * 6)


def _general_integers(m):
    R, I = m.RangedConstraintRelation, m.VariableType.INTEGER
    rows = [[3, 1, 4, 1, 5, 2, 6, 2, 1, 3], [1, 2, 2, 3, 1, 4, 1, 2, 3, 2],
            [2, 3, 1, 2, 2, 1, 3, 1, 2, 4]]
    return m._gf(m.Objective.MAXIMIZE, rows, [R.less()] * 3, [17, 11, 13],
                 [7, 2, 9, 4, 8, 3, 6, 5, 1, 10], [(0, 2)] * 10, [I] * 10)


def _strong_branching(m):
    """min 10x + y, 2x + y >= 4, y in [0,1], x integer in [0,3]."""
    R, V = m.RangedConstraintRelation, m.VariableType
    return m._gf(m.Objective.MINIMIZE, [[2, 1]], [R.greater()], [4], [10, 1],
                 [(0, 3), (0, 1)], [V.INTEGER, V.CONTINUOUS], names=["x", "y"])


def _dive(m):
    """min x1 + 1.01 x2, 2x1 + 2x2 >= 7, x integer in [0,3]."""
    R, I = m.RangedConstraintRelation, m.VariableType.INTEGER
    return m._gf(m.Objective.MINIMIZE, [[2, 2]], [R.greater()], [7],
                 [1, Fraction(101, 100)], [(0, 3), (0, 3)], [I, I],
                 names=["x1", "x2"])


def _presolve_infeasible(m):
    """5 <= 10x <= 8 with x integer: presolve's rounding empties x's window."""
    R, V = m.RangedConstraintRelation, m.VariableType
    return m._gf(m.Objective.MINIMIZE, [[10, 0], [0, 1]], [R.ranged(3), R.less()],
                 [8, 9], [1, 1], [(0, 3), (0, 9)], [V.INTEGER, V.CONTINUOUS])


def _integer_window(m):
    """x integer with 1/5 <= x <= 4/5: LP feasible, no integer point."""
    R, I = m.RangedConstraintRelation, m.VariableType.INTEGER
    return m._gf(m.Objective.MINIMIZE, [[1]], [R.less()], [1], [1],
                 [(Fraction(1, 5), Fraction(4, 5))], [I])


def _mixed(m):
    """min -(x+y), x continuous in [0, 3/2], y integer in [0,10], x+y<=27/10."""
    R, V = m.RangedConstraintRelation, m.VariableType
    return m._gf(m.Objective.MINIMIZE, [[1, 1]], [R.less()], [Fraction(27, 10)],
                 [-1, -1], [(0, Fraction(3, 2)), (0, 10)],
                 [V.CONTINUOUS, V.INTEGER], names=["x", "y"])


def _unbounded_integer(m):
    R, I = m.RangedConstraintRelation, m.VariableType.INTEGER
    return m._gf(m.Objective.MINIMIZE, [[1, 1], [1, -1]], [R.greater(), R.less()],
                 [1, 5], [1, 1], [(0, None), (0, 9)], [I, I])


# name -> (GeneralForm factory, config overrides, solve_mip keywords)
CASES = {
    "knapsack_vs_brute_force": (_knapsack, {}, dict(batch_width=4)),
    "general_integers": (_general_integers, {}, dict(batch_width=8)),
    "general_integers_cut_free": (_general_integers, {},
                                  dict(batch_width=8, gomory_cuts=0)),
    "gomory_cuts": (_two_var, {}, dict(gomory_cuts=8)),
    "no_gomory_cuts": (_two_var, {}, dict(gomory_cuts=0)),
    "strong_branching_fixes_a_side": (_strong_branching, dict(presolve=False),
                                      dict(gomory_cuts=0, strong_branching=8)),
    "without_strong_branching": (_strong_branching, dict(presolve=False),
                                 dict(gomory_cuts=0, strong_branching=0)),
    "rounding_dive": (_dive, dict(presolve=False),
                      dict(gomory_cuts=0, strong_branching=0)),
    "rel_gap": (_two_var, {}, dict(gomory_cuts=0, rel_gap=Fraction(1, 2))),
    "time_limit_zero": (_two_var, {}, dict(gomory_cuts=0, time_limit_s=0.0)),
    "presolve_infeasible": (_presolve_infeasible, {}, {}),
    "integer_infeasible_window": (_integer_window, {}, {}),
    "mixed_integer_continuous": (_mixed, {}, {}),
}


def _verdict(res, dtype):
    out = (res.status.value, res.objective, res.best_bound, res.gap,
           res.certified, res.root_objective, res.best_bound_exact,
           res.time_limit_hit, res.node_limit_hit, res.dive_incumbent)
    if dtype == "float64":
        out += (res.nodes_solved, res.nodes_pruned, res.dive_lps)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_mip_cases_match_jax(name, dtype):
    build, overrides, kw = CASES[name]
    options = dict(SMALL, dtype=dtype, **overrides)
    jax_res = jax_solve_mip(build(JAX_MIP), JaxConfig(**options), **kw)
    port_res = solve_mip(build(PORT_MIP), SolverConfig(platform="cpu", **options), **kw)
    assert _verdict(port_res, dtype) == _verdict(jax_res, dtype)
    if jax_res.solution is not None:
        assert (list(port_res.solution.solution_values)
                == list(jax_res.solution.solution_values))


@pytest.mark.parametrize("dtype", DTYPES)
def test_unbounded_integer_is_rejected_by_both(dtype):
    options = dict(SMALL, dtype=dtype)
    with pytest.raises(NotImplementedError):
        jax_solve_mip(_unbounded_integer(JAX_MIP), JaxConfig(**options))
    with pytest.raises(NotImplementedError):
        solve_mip(_unbounded_integer(PORT_MIP), SolverConfig(platform="cpu", **options))


def test_solve_mip_runs_on_cuda_by_default():
    """platform=None means CUDA: without a card the MIP path raises too."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_mip(_knapsack(PORT_MIP), SolverConfig(**SMALL))


def test_knapsack_node_waves_leave_the_batch_alike(monkeypatch):
    """chip_smoke's mip/real instance (relp_tpu_torch.testing.mknap) at a
    small budget: both packages reach the same exact best bound after the
    same nodes, and send the same node LPs from the batch to the
    single-LP driver (most of them: the batch's f32 residual gate)."""
    import relp_tpu.parallel.batch_driver as jax_batch
    import relp_tpu_torch.parallel.batch_driver as port_batch
    import relp_tpu_torch.testing as testing

    jax_testing = twin("relp_tpu_torch.testing", "relp_tpu")
    fallbacks = {}
    for name, module in (("jax", jax_batch), ("port", port_batch)):
        kept = module._single_lp_fallback

        def counted(*args, _kept=kept, _name=name, **kwargs):
            fallbacks[_name] = fallbacks.get(_name, 0) + 1
            return _kept(*args, **kwargs)

        monkeypatch.setattr(module, "_single_lp_fallback", counted)
    kw = dict(batch_width=8, node_limit=24)
    jax_res = jax_solve_mip(jax_testing.mknap(**testing.MKNAP), JaxConfig(), **kw)
    port_res = solve_mip(testing.mknap(**testing.MKNAP), SolverConfig(platform="cpu"), **kw)
    assert _verdict(port_res, "float64") == _verdict(jax_res, "float64")
    assert port_res.best_bound_exact and port_res.best_bound > port_res.root_objective
    assert fallbacks["port"] == fallbacks["jax"] > port_res.nodes_solved // 2


def test_knapsack_node_waves_stay_in_the_batch_in_f64(monkeypatch):
    """The same instance and budget in f64 (chip_smoke's mip/real64): both
    packages visit the same nodes to the same exact best bound, and every
    node LP of every wave is solved inside solve_batch (f64 passes the
    batch driver's residual gates)."""
    import relp_tpu_torch.parallel.batch_driver as port_batch
    import relp_tpu_torch.testing as testing

    jax_testing = twin("relp_tpu_torch.testing", "relp_tpu")
    kept, lps = port_batch.solve_batch, []

    def counted(*args, **kwargs):
        results = kept(*args, **kwargs)
        lps.extend(results)
        return results

    monkeypatch.setattr(port_batch, "solve_batch", counted)
    kw = dict(batch_width=8, node_limit=24)
    jax_res = jax_solve_mip(jax_testing.mknap(**testing.MKNAP),
                            JaxConfig(dtype="float64"), **kw)
    port_res = solve_mip(testing.mknap(**testing.MKNAP),
                         SolverConfig(platform="cpu", dtype="float64"), **kw)
    assert _verdict(port_res, "float64") == _verdict(jax_res, "float64")
    assert lps and not any(r.stats.batch_fallback for r in lps)
    assert port_res.best_bound_exact and port_res.best_bound > port_res.root_objective
