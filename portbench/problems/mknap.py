"""Knapsacks of a configuration's class as both sides take them: the
instance from the seed (``portbench.gen.mknap``), the model the program is
given, and the LP and checks the plain reference works from.

A configuration names this module under ``"problem"``; an entry that
streams LPs or families reads it through the functions below, so that a
later problem is a module beside this one.  ``model`` is the only function
that reaches the program, and only when it is called.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List

from portbench.gen import mknap
from portbench.reference import lp as ref
from portbench.reference import mknap as ref_mknap


def draw(cfg: Dict, seed: int, index: int):
    """(W, capacity, profit) of instance ``index`` of the run of ``seed``."""
    return mknap.instance(cfg, seed, index)


def model(data, integer: bool = False):
    """The knapsack as the program takes it (as tests/data/knap6.mps):
    minimise -profit.x subject to W x <= capacity, 0 <= x <= 1; with
    ``integer`` the items are binary, else it is the LP relaxation."""
    from relp_tpu_torch.data.elements import Objective, RangedConstraintRelation
    from relp_tpu_torch.data.general_form import GeneralForm, Variable, VariableType
    from relp_tpu_torch.linalg.sparse import SparseColumnMatrix

    W, capacity, profit = data
    F = Fraction
    kind = VariableType.INTEGER if integer else VariableType.CONTINUOUS
    m, n = W.shape
    columns = [[(i, F(int(W[i, j]))) for i in range(m) if W[i, j]] for j in range(n)]
    return GeneralForm(
        objective=Objective.MINIMIZE,
        constraints=SparseColumnMatrix(columns, m),
        constraint_types=[RangedConstraintRelation.less() for _ in range(m)],
        b=[F(int(v)) for v in capacity],
        variables=[Variable(kind, F(-int(p)), F(0), F(1)) for p in profit],
        variable_names=names(data),
    )


def reference_lp(data) -> ref.LP:
    """The LP relaxation in the reference's standard form."""
    return ref_mknap.relaxation(*data)


def names(data) -> List[str]:
    """The variable names of ``model``, in column order."""
    return [f"x{j}" for j in range(data[0].shape[1])]


def point_holds(data, values: Dict[str, Fraction], objective: Fraction) -> bool:
    """Whether the named values are a point of the LP relaxation (every row
    and bound exactly) whose objective is ``objective``."""
    return ref_mknap.point_holds(*data, values, objective, integer=False)


def family(cfg: Dict, seed: int, index: int, size: int):
    """``size`` scenarios that share one instance's weights and profits
    (family ``index`` of the run of ``seed``) and differ in their
    capacities: scenario k's are the recipe's floor(tightness * sum_j w_ij)
    of another instance of the run, drawn on its own weights."""
    W, _capacity, profit = mknap.instance(cfg, seed, index)
    return [(W, mknap.instance(cfg, seed, 1 + (index + 1) * size + k)[1], profit)
            for k in range(size)]
