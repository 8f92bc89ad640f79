"""The generated LP shared by ``chip_smoke.py`` and the CPU tests.

A dense-ish random LP of netlib-class dimensions that is exact (integer
data), feasible by construction (x is a witness) and bounded (every variable
boxed to [0, 10]), so both simplex phases run.  Keep the order of the random
draws: the expected objective below depends on it.

``scenario_family`` perturbs its right-hand side into a family of scenarios
for ``solve_batch``, with the recipe of ``scripts/batch_scenarios.py``.
"""

from __future__ import annotations

import copy
import hashlib
from fractions import Fraction

import numpy as np

from relp_tpu_torch._host import (
    GeneralForm,
    Objective,
    RangedConstraintRelation,
    SparseColumnMatrix,
    Variable,
    VariableType,
)

# The real-size case: m=384, n=1536, seed 7.  Its exact optimum (a Fraction
# of value -15800.2035498...) is pinned by sha256(str(objective)), taken from
# a certified solve by the JAX package.
REAL_SIZE = dict(m=384, n=1536, seed=7)
REAL_SIZE_OBJECTIVE_SHA256 = (
    "bcfc1e250b31a8760e462fb93c0e3ea42c2e2edaa1517a34a2ee13862a0bb7e5"
)

# The two scenario families of chip_smoke's batch phases: rhs-perturbed
# copies of the generated LP, seed 7, salt 0.  "resident": m=32, n=96 (an
# ADLITTLE-class problem, lowered 128 x 384), 256 scenarios; "blocked":
# m=128, n=384 (lowered 512 x 1408), 128 scenarios.  Each digest is
# objectives_digest of the certified results, taken from the JAX package's
# solve_batch on the CPU (the exact optimum of a scenario does not depend
# on the batch it is solved in).
FAMILIES = {
    "resident": dict(m=32, n=96, seed=7, count=256),
    "blocked": dict(m=128, n=384, seed=7, count=128),
}
FAMILY_OBJECTIVES_SHA256 = {
    "resident": "d3be04389b67799e1a3c40c1f7926ece4879840225510f192bb15a9c8cabfcdb",
    "blocked": "381819114dc7fadd7add86c7de24f448acc1cdcebae9418b70248f9e09f3c735",
}

# The family of chip_smoke's warm-restart phase: the resident family's LP
# with +-40% wobbles (denominator 2500), so that the base optimum's basis is
# primal infeasible for every scenario and each needs dual pivots; all 256
# stay feasible.  Its digest is from the JAX package's cold solve_batch on
# the CPU, as above.
WARM_FAMILY = dict(m=32, n=96, seed=7, count=256, denominator=2500)
WARM_FAMILY_OBJECTIVES_SHA256 = (
    "dea13620f0788273c996e0fd5b60b2c2281e8f1d301918dc3d4267ea10c08203"
)


def generated_lp_data(m: int, n: int, seed: int):
    """The raw data (A, b, c, relation kinds) of the generated LP.

    Row i is <= for i % 3 == 0, >= for i % 3 == 1 and == otherwise.
    """
    rng = np.random.default_rng(seed)
    A = rng.integers(-4, 5, size=(m, n))
    A[rng.random((m, n)) < 0.7] = 0
    x = rng.integers(0, 4, size=n)
    ax = A @ x
    kinds, b = [], []
    for i in range(m):
        if i % 3 == 0:
            kinds.append("<=")
            b.append(int(ax[i]) + int(rng.integers(0, 5)))
        elif i % 3 == 1:
            kinds.append(">=")
            b.append(int(ax[i]) - int(rng.integers(0, 5)))
        else:
            kinds.append("==")
            b.append(int(ax[i]))
    c = rng.integers(-5, 6, size=n)
    return A, np.asarray(b), c, kinds


def generated_lp(m: int, n: int, seed: int) -> GeneralForm:
    """The generated LP as a (fresh, mutable) GeneralForm: minimise c.x
    subject to the rows above and 0 <= x <= 10."""
    A, b, c, kinds = generated_lp_data(m, n, seed)
    relation = {
        "<=": RangedConstraintRelation.less,
        ">=": RangedConstraintRelation.greater,
        "==": RangedConstraintRelation.equal,
    }
    F = Fraction
    return GeneralForm(
        objective=Objective.MINIMIZE,
        constraints=SparseColumnMatrix.from_dense(
            [[F(int(v)) for v in row] for row in A]
        ),
        constraint_types=[relation[k]() for k in kinds],
        b=[F(int(v)) for v in b],
        variables=[
            Variable(VariableType.CONTINUOUS, F(int(cj)), F(0), F(10)) for cj in c
        ],
        variable_names=[f"x{j}" for j in range(n)],
    )


def scenario_base(m: int, n: int, seed: int):
    """The presolved, standardized generated LP and its standardize counts:
    the base problem of a scenario family."""
    gf = generated_lp(m, n, seed)
    gf.presolve()
    return gf, gf.standardize()


def scenario_family(m: int, n: int, seed: int, count: int,
                    denominator: int = 100_000):
    """Providers of scenarios 0 .. count - 1 of the family: row i of
    scenario s has b[i] * (1 + ((s 7919 + i 104729) mod 2001 - 1000) /
    denominator), in exact arithmetic (with the default, +-1%, the recipe of
    scripts/batch_scenarios.py with salt 0).  All share the base's matrix
    and costs, so they suit ``solve_batch(..., shared_structure=True)``."""
    base, counts = scenario_base(m, n, seed)
    providers = []
    for s in range(count):
        gf = copy.deepcopy(base)
        for i in range(len(gf.b)):
            wobble = Fraction((s * 7919 + i * 104729) % 2001 - 1000, denominator)
            gf.b[i] = gf.b[i] * (1 + wobble)
        providers.append(gf.derive_matrix_data(counts))
    return providers


def objectives_digest(objectives) -> str:
    """sha256 of the exact objectives, one ``str(Fraction)`` per line."""
    return hashlib.sha256(
        "\n".join(str(v) for v in objectives).encode()
    ).hexdigest()
