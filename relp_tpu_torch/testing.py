"""The generated LP shared by ``chip_smoke.py`` and the CPU tests.

A dense-ish random LP of netlib-class dimensions that is exact (integer
data), feasible by construction (x is a witness) and bounded (every variable
boxed to [0, 10]), so both simplex phases run.  Keep the order of the random
draws: the expected objective below depends on it.

``scenario_family`` perturbs its right-hand side into a family of scenarios
for ``solve_batch``, with the recipe of ``scripts/batch_scenarios.py``.
``synthetic_problem`` is the Gaussian LP of the kernel tests, as dense
arrays.
"""

from __future__ import annotations

import copy
import hashlib
from fractions import Fraction

import numpy as np

from relp_tpu_torch.data.elements import Objective, RangedConstraintRelation
from relp_tpu_torch.data.general_form import GeneralForm, Variable, VariableType
from relp_tpu_torch.linalg.device import pad_to_multiple
from relp_tpu_torch.linalg.sparse import SparseColumnMatrix

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


# The MIP of chip_smoke's mip/real phase: a multidimensional 0/1 knapsack by
# Chu & Beasley's recipe (OR-Library mknapcb, J. Heuristics 4 (1998) 63-86)
# at the size of mknapcb1: 5 constraints, 100 binaries, tightness 0.25.
MKNAP = dict(m=5, n=100, tightness=0.25, seed=7)


def mknap_data(m: int, n: int, tightness: float, seed: int):
    """(W, capacity, profit): weights w_ij uniform on 1..1000, capacity_i =
    floor(tightness * sum_j w_ij), profit_j = sum_i w_ij // m plus a uniform
    draw on 0..500 (profits correlated with the weights)."""
    rng = np.random.default_rng(seed)
    W = rng.integers(1, 1001, size=(m, n))
    capacity = np.floor(tightness * W.sum(axis=1)).astype(np.int64)
    profit = W.sum(axis=0) // m + rng.integers(0, 501, size=n)
    return W, capacity, profit


def mknap(m: int, n: int, tightness: float, seed: int) -> GeneralForm:
    """The knapsack as a GeneralForm in the minimize sense (as
    tests/data/knap6.mps): minimise -profit.x subject to W x <= capacity and
    x binary."""
    W, capacity, profit = mknap_data(m, n, tightness, seed)
    F = Fraction
    return GeneralForm(
        objective=Objective.MINIMIZE,
        constraints=SparseColumnMatrix.from_dense(
            [[F(int(v)) for v in row] for row in W]
        ),
        constraint_types=[RangedConstraintRelation.less() for _ in range(m)],
        b=[F(int(v)) for v in capacity],
        variables=[
            Variable(VariableType.INTEGER, F(-int(p)), F(0), F(1)) for p in profit
        ],
        variable_names=[f"x{j}" for j in range(n)],
    )


# The LP of chip_smoke's first_order/pdhg phase: 2048 x 8192 in equality
# form, its f32 matrix (67 MB) larger than the H100's 50 MB L2.
PDHG_SIZE = dict(m=2048, n=8192, seed=7)
# The same PDHG call in f64 on the CPU (tol 1e-6, 20,000 iterations), with
# the returned point's residuals in the scaled system recomputed on the host:
#   python -m relp_tpu_torch.tools.pdhg_check --platform cpu --dtype float64
PDHG_F64_CPU = dict(iterations=20_000, restarts=8, primal=9.840506043556113e-05,
                    gap=2.2290309039032867e-06)


def pdhg_lp(m: int, n: int, seed: int):
    """(A, b, c, u) of a feasible, bounded LP min c.x s.t. A x = b, 0 <= x <= u:
    30% nonzeros, integers in -9..9, b = A x0 for x0 uniform on [0, 10]^n,
    u = 10 and integer costs in -5..5."""
    rng = np.random.default_rng(seed)
    A = rng.integers(1, 10, size=(m, n)) * rng.choice([-1, 1], size=(m, n))
    A = np.where(rng.random((m, n)) < 0.3, A, 0).astype(np.float64)
    b = A @ rng.uniform(0.0, 10.0, size=n)
    c = rng.integers(-5, 6, size=n).astype(np.float64)
    return A, b, c, np.full(n, 10.0)


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


def synthetic_problem(m=32, n=64, pad=32, dtype=np.float64, seed=0):
    """A feasible random standard-form LP already lowered to dense arrays,
    (A, b, c1, c2, cand, basis): Gaussian m x n data, one artificial per
    padded row, phase-1 costs c1, real costs c2 and the artificial basis.
    The draws of the JAX package's ``__graft_entry__._synthetic_problem``,
    so both packages' tests start from the same arrays."""
    rng = np.random.default_rng(seed)
    M = pad_to_multiple(m, pad)
    art = n
    N = pad_to_multiple(n + M, pad)
    A = np.zeros((M, N), dtype=dtype)
    dense = rng.standard_normal((m, n)).astype(dtype)
    A[:m, :n] = dense
    for i in range(M):
        A[i, art + i] = 1.0
    x_feas = np.abs(rng.standard_normal(n)).astype(dtype)
    b = np.zeros(M, dtype=dtype)
    b[:m] = np.abs(dense @ x_feas)  # keep rhs nonnegative
    c1 = np.zeros(N, dtype=dtype)
    c1[art : art + m] = 1.0
    c2 = np.zeros(N, dtype=dtype)
    c2[:n] = rng.standard_normal(n)
    cand = np.zeros(N, dtype=bool)
    cand[:n] = True
    basis = np.arange(art, art + M, dtype=np.int32)
    return A, b, c1, c2, cand, basis
