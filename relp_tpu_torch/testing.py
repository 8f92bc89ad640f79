"""The generated LP shared by ``chip_smoke.py`` and the CPU tests.

A dense-ish random LP of netlib-class dimensions that is exact (integer
data), feasible by construction (x is a witness) and bounded (every variable
boxed to [0, 10]), so both simplex phases run.  Keep the order of the random
draws: the expected objective below depends on it.

``scenario_family`` perturbs its right-hand side into a family of scenarios
for ``solve_batch``, with the recipe of ``scripts/batch_scenarios.py``.
``synthetic_problem`` is the Gaussian LP of the kernel tests, as dense
arrays.  ``RecordingGraph`` is the CPU's stand-in for a CUDA graph that the
tests of captured chunks and steps replay through, in one process and in
the mesh tests' gloo workers (``recording_graphs``).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
from fractions import Fraction

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

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


def synthetic_start(m=32, n=64, pad=32, dtype=np.float64, seed=0, device="cpu"):
    """``synthetic_problem`` at its artificial start as the inputs of a
    chunk on ``device``: (state, A, c1, c2, candidate_mask), the state
    priced with the phase-1 costs c1."""
    from relp_tpu_torch.simplex.state import RUNNING, state_from_numpy

    A, b, c1, c2, cand, basis = synthetic_problem(m=m, n=n, pad=pad, dtype=dtype,
                                                  seed=seed)
    M, N = A.shape
    in_basis = np.zeros(N, dtype=bool)
    in_basis[basis] = True
    cB = c1[basis]
    zero = np.int32(0)
    state = state_from_numpy(
        dict(Binv=np.eye(M, dtype=dtype), basis=basis, xB=b, pi=cB,
             obj=np.asarray(cB @ b, dtype=dtype), in_basis=in_basis,
             gamma=np.ones(N, dtype=dtype), iteration=zero, status=np.int32(RUNNING),
             degen_count=zero, inner=zero, price_start=zero,
             d=(c1 - cB @ A).astype(dtype)),
        device,
    )
    return (state, *(torch.as_tensor(x, device=device) for x in (A, c1, c2, cand)))


# The kinds of chunk that ``chunk_case`` builds: primal steepest edge, the
# same with the phase-1 stop at zero, in f64, with the scans on a bf16 copy
# of the tableau, and the dual chunk.
CHUNK_KINDS = ("steepest", "stop_at_zero", "float64", "bfloat16_scan", "dual")


def chunk_case(kind, state, A, c, candidate_mask, chunk=60):
    """(name, args, kwargs) of one kind of chunk (``CHUNK_KINDS``) from an
    f32 start ``state`` of ``synthetic_start``: ``name`` is the function of
    ``relp_tpu_torch.simplex.kernels`` (and of ``graphs.ChunkGraphs``) to
    call.  The dual chunk starts from the basic values negated, so that it
    pivots."""
    from relp_tpu_torch.simplex.kernels import PRICE_STEEPEST

    tols = dict(opt_tol=1e-7, pivot_tol=1e-7)
    primal = dict(pricing=PRICE_STEEPEST, chunk=chunk, degen_tol=1e-7, **tols)
    if kind == "dual":
        return ("dual_run_chunk", (state._replace(xB=-state.xB), A, A, c, candidate_mask),
                dict(chunk=chunk, feas_tol=1e-7, **tols))
    if kind == "float64":
        state = state._replace(**{f: getattr(state, f).double() for f in
                                  ("Binv", "xB", "pi", "obj", "gamma", "d")})
        A, c = A.double(), c.double()
    A_scan = A
    if kind == "bfloat16_scan":
        A_scan = A.to(torch.bfloat16)
        state = state._replace(d=state.d.to(torch.bfloat16))
    return ("run_chunk", (state, A_scan, A, c, candidate_mask),
            dict(primal, stop_at_zero=kind == "stop_at_zero"))


def lu_start(m=32, n=64, pad=32, dtype=np.float32, seed=0, capacity=60, device="cpu"):
    """``synthetic_problem`` at its artificial start as the inputs of an LU
    chunk on ``device``: (state, A, c1, c2, candidate_mask), the state with
    fresh factors of the start basis, an empty ring of ``capacity`` slots,
    priced with the phase-1 costs c1."""
    from relp_tpu_torch.simplex import lu
    from relp_tpu_torch.simplex.state import RUNNING

    A, b, c1, c2, cand, basis = synthetic_problem(m=m, n=n, pad=pad, dtype=dtype,
                                                  seed=seed)
    A_t, b_t, c1_t, c2_t, cand_t, basis_t = (
        torch.as_tensor(x, device=device) for x in (A, b, c1, c2, cand, basis))
    factors, piv, B0, eta_vals, eta_rows, xB, pi, obj, _res = lu.lu_refactorize(
        A_t, b_t, c1_t, basis_t, eta_capacity=capacity)
    in_basis = torch.zeros(A.shape[1], dtype=torch.bool, device=device)
    in_basis[basis_t.long()] = True
    zero = torch.zeros((), dtype=torch.int32, device=device)
    state = lu.LUState(
        lu=factors, piv=piv, B0=B0, eta_vals=eta_vals, eta_rows=eta_rows,
        eta_count=zero, basis=basis_t, xB=xB, pi=pi, obj=obj, in_basis=in_basis,
        gamma=torch.ones(A.shape[1], dtype=A_t.dtype, device=device),
        iteration=zero, status=torch.tensor(RUNNING, dtype=torch.int32, device=device),
        inner=zero, price_start=zero)
    return state, A_t, c1_t, c2_t, cand_t


def eta_ring_case(M, K, dtype, fill, seed=0, repeat_rows=False):
    """(eta_vals, eta_rows, eta_count, x) as numpy arrays for the eta-ring
    passes (``relp_tpu_torch.ops.eta_ring``): a ring of K slots of length
    M, every slot (the dead ones too) an eta with a pivot w_k[r_k] of
    magnitude 1-2 and other entries of about 1/sqrt(M), its row drawn at
    random (from the first three with ``repeat_rows``); the live count
    ``fill`` and a Gaussian vector."""
    rng = np.random.default_rng([M, K, fill, seed, int(repeat_rows)])
    vals = rng.standard_normal((K, M)) / np.sqrt(M)
    rows = rng.integers(0, min(M, 3) if repeat_rows else M, K)
    signs = np.where(rng.random(K) < 0.5, -1.0, 1.0)
    vals[np.arange(K), rows] = signs * (1.0 + rng.random(K))
    x = rng.standard_normal(M)
    return vals.astype(dtype), rows.astype(np.int32), np.int32(fill), x.astype(dtype)


# The kinds of chunk of the LU, df32 and PDHG bodies that ``body_case``
# builds: the LU chunk with steepest edge from an empty ring, from a ring
# of LU_ETA0 etas, the same with phase 1's stop at zero and with Dantzig
# pricing; the df32 chunk (steepest edge); the PDHG chunk.
BODY_KINDS = ("lu_steepest", "lu_steepest_eta", "lu_stop_at_zero_eta",
              "lu_dantzig_eta", "df32", "pdhg")
LU_ETA0 = 7


def body_case(kind, m, n, pad=128, seed=7, device="cpu", chunk=60):
    """(start, eager, graphed) of one kind of chunk (``BODY_KINDS``) on
    ``device``: ``eager(state)`` runs the body eagerly from ``state``,
    ``graphed(cache, state)`` the same chunk through a
    ``simplex.graphs.ChunkGraphs`` cache, and ``start`` is the chunk-entry
    state.  The simplex kinds start from ``synthetic_problem(m, n, pad,
    seed)`` (f32; the df32 chunk from its f64 lowering, split), the LU
    kinds ending in ``_eta`` after an eager chunk of LU_ETA0 pivots; the
    PDHG chunk from ``pdhg_lp(m, n, seed)`` scaled as ``pdhg_solve`` scales
    it, at a zero iterate with the Halpern counter at 200 and a primal
    weight of 2."""
    from relp_tpu_torch.firstorder import pdhg
    from relp_tpu_torch.ops.df32 import df_from_f64
    from relp_tpu_torch.simplex import df_kernels, lu
    from relp_tpu_torch.simplex.kernels import PRICE_DANTZIG, PRICE_STEEPEST

    tols = dict(opt_tol=1e-7, pivot_tol=1e-7, degen_tol=1e-7)
    if kind.startswith("lu_"):
        state, A, c1, _c2, mask = lu_start(m=m, n=n, pad=pad, seed=seed, device=device)
        args = (A, A, c1, mask)
        kw = dict(tols, chunk=chunk, stop_at_zero="stop_at_zero" in kind,
                  pricing=PRICE_DANTZIG if "dantzig" in kind else PRICE_STEEPEST)
        if kind.endswith("_eta"):
            state = lu.lu_run_chunk(state, *args, **dict(kw, chunk=LU_ETA0))
        return (state, lambda st: lu.lu_run_chunk(st, *args, **kw),
                lambda cache, st: cache.lu_run_chunk(st, *args, **kw))
    if kind == "df32":
        A64, b64, c64, _c2, cand, basis = synthetic_problem(m=m, n=n, pad=pad, seed=seed)
        state = df_kernels.df_make_state(A64, b64, c64, basis, device)
        (Ah, Al), (ch, cl) = df_from_f64(A64, device), df_from_f64(c64, device)
        args = (Ah, Ah, Al, ch, cl, torch.as_tensor(cand, device=device))
        kw = dict(tols, chunk=chunk, pricing=PRICE_STEEPEST)
        return (state, lambda st: df_kernels.df_run_chunk(st, *args, **kw),
                lambda cache, st: cache.df_run_chunk(st, *args, **kw))
    if kind == "pdhg":
        As, bs, cs, us, _d_row, _d_col = pdhg.scale_problem(*pdhg_lp(m, n, seed), np.float32)
        A, b, c, u = (torch.as_tensor(v, device=device) for v in (As, bs, cs, us))
        inputs = dict(A=A, b=b, c=c, u=u)
        step, w = 0.9 / pdhg._power_norm(A), 2.0
        x, y = torch.zeros_like(c), torch.zeros_like(b)
        state = pdhg.pdhg_carry(x, y, x, y, 200.0, step / w, step * w)
        return (state, lambda st: pdhg._pdhg_chunk(st, **inputs, chunk=chunk),
                lambda cache, st: cache.run(pdhg._pdhg_chunk, st, inputs, chunk=chunk))
    raise ValueError(f"unknown kind of chunk {kind!r}")


# The kinds of device step of ``solve_batch`` that ``step_case`` builds: its
# ``_batch_step`` through each batched-pivot kernel (the kernel route; the
# family's shape decides the kernel), on the batched torch path in f32 and
# in f64 (with the default f32 scans: a cast of the tableau), the dual
# chunk of a warm restart and the f64 polish chunk.
STEP_KINDS = ("kernel", "torch_float32", "torch_float64", "dual", "polish")


def step_case(kind, family, device="cpu", chunk=25, stop_at_zero=True, mesh=None):
    """(body, state, inputs, static) of one of ``solve_batch``'s device
    steps (``STEP_KINDS``) on ``device``, for
    ``parallel.batch_driver.run_step(body, state, inputs, graphed=...,
    **static)`` (``static`` also holds the kernel route's ``must_launch``).
    The family (``scenario_family``'s keywords) is lowered as
    ``solve_batch`` lowers it, one tableau expanded over the batch, with
    chip_smoke's batch configuration (pad 128); with ``mesh`` this rank's
    scenarios and column block of it, as ``solve_batch(mesh=...)`` places
    them, the shard in ``static`` (the batched torch path and the polish
    chunk only: the kernels and the dual chunk do not run under a mesh).
    The steps start from the phase-1 start with fresh steepest-edge
    weights, on the phase-1 costs with ``stop_at_zero``, else on the real
    costs; the dual chunk from the optimal basis of the family's
    unperturbed base, refactorized as the warm restart does (``family`` then wobbles enough that the scenarios
    need dual pivots: WARM_FAMILY); the polish chunk is the batched chunk
    at f64 on the f64 tableau with the real costs, from the f64 family's
    phase-1 start."""
    from relp_tpu_torch.config import SolverConfig
    from relp_tpu_torch.parallel import batch
    from relp_tpu_torch.parallel.batch_driver import _batch_step, cast_tableau, lower_batch
    from relp_tpu_torch.simplex import solve_relaxation
    from relp_tpu_torch.simplex.engine import scan_dtype
    from relp_tpu_torch.simplex.kernels import PRICE_STEEPEST

    device = torch.device(device)
    dtype = "float64" if kind in ("torch_float64", "polish") else "float32"
    cfg = SolverConfig(platform=device.type, dtype=dtype, pad_to=128, chunk_size=150,
                       refactor_period=150)
    problems, A, b, c1, c2, cand, st = lower_batch(
        scenario_family(**family), cfg, device, shared_structure=True)
    mixed = cfg.scan_dtype not in ("same", cfg.dtype)
    A_scan = cast_tableau(A, scan_dtype(cfg)) if mixed else A
    shard = None
    if mesh is not None:
        from relp_tpu_torch.parallel import sharded

        if kind in ("kernel", "dual"):
            raise ValueError(f"the {kind} step does not run under a mesh")
        lo, hi = sharded.batch_block(mesh, A.shape[0])
        shard = sharded.column_shard(mesh, A.shape[2], device)
        A, b, c1, cand, A_scan_s = sharded.shard_batch_problem(
            mesh, A, b, c1, cand, A_scan=A_scan if mixed else None)
        A_scan = A_scan_s if mixed else A
        c2 = shard.take(c2[lo:hi])
        st = sharded.shard_batch_state(mesh, st)
    tols = dict(opt_tol=cfg.opt_tol, pivot_tol=cfg.pivot_tol)
    if kind == "dual":
        gf, counts = scenario_base(family["m"], family["n"], family["seed"])
        base = solve_relaxation(gf.derive_matrix_data(counts), cfg).basis
        full = problems[0].initial_basis.copy()
        full[: len(base)] = base
        in_basis = torch.zeros(A.shape[2], dtype=torch.bool, device=device)
        in_basis[torch.as_tensor(full, dtype=torch.int64, device=device)] = True
        count = A.shape[0]
        st = st._replace(
            basis=torch.as_tensor(full, dtype=torch.int32, device=device).repeat(count, 1),
            in_basis=in_basis.repeat(count, 1))
        Binv, xB, pi, obj, _res = batch._v_refactor(A, b, c2, st.basis, newton_steps=1)
        xB = torch.where(xB > -cfg.feas_tol, torch.clamp_min(xB, 0.0), xB)
        return (batch.batched_dual_run_chunk,
                st._replace(Binv=Binv, xB=xB, pi=pi, obj=obj),
                dict(A_scan=A_scan, A_full=A, c=c2, candidate_mask=cand),
                dict(chunk=chunk, feas_tol=cfg.feas_tol, noisy_scan=False, **tols))
    st = st._replace(gamma=batch._v_gamma(st.Binv, A_scan, st.in_basis))
    primal = dict(pricing=PRICE_STEEPEST, chunk=chunk, degen_tol=cfg.feas_tol,
                  noisy_scan=False, **tols)
    if kind == "polish":
        return (batch.batched_run_chunk, st,
                dict(A_scan=A, A_full=A, c=c2, candidate_mask=cand),
                dict(primal, shard=shard))
    mega = kind == "kernel"
    static = dict(primal, stop_at_zero=stop_at_zero, hi_scan=False, mega=mega,
                  newton_steps=3 if dtype == "float64" else 1, feas_tol=cfg.feas_tol,
                  refactor_period=0, use_steepest=True, shard=shard)
    if mega:
        static["must_launch"] = batch._megakernel_variant(A.shape)
    return (_batch_step, st,
            dict(A_scan=A_scan, A=A, b=b, c=c1 if stop_at_zero else c2, cand=cand),
            static)


# What a CUDA graph capture cannot hold: a host read of a value, a tensor
# made from host data, an output whose size depends on the data.
_REFUSED = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.lift_fresh.default,
            torch.ops.aten.lift_fresh_copy.default, torch.ops.aten.nonzero.default}


def _wait(func, out) -> None:
    """Wait for the ``Work`` that a collective (a ``c10d`` op, under gloo
    run on gloo's own threads) returns last, before anything reads its
    result."""
    if func.namespace == "c10d":
        out[-1].wait()


class _Recorder(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _REFUSED:
            raise RuntimeError(f"{func} inside a capture")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        _wait(func, out)
        self.ops.append((func, args, kwargs, out))
        return out


class RecordingGraph:
    """The CPU's stand-in for ``torch.cuda.CUDAGraph``: between
    ``capture_begin`` and ``capture_end`` it records every aten op the
    chunk runs, and every collective (``c10d`` op: ``allreduce_``,
    ``_allgather_base_``), with the tensors it reads and writes, and its
    ``replay`` runs them again in order on the same tensors, each result
    written into the tensor the capture made, each collective waited for.
    Like a CUDA graph it fixes every tensor's identity at capture and
    refuses what a capture refuses: a read of a tensor's value on the host
    and a tensor made from host data."""

    def __init__(self):
        self.ops = []
        self._mode = None

    def capture_begin(self, *args, **kwargs):
        self._mode = _Recorder(self.ops)
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)

    def replay(self):
        for func, args, kwargs, out in self.ops:
            again = func(*args, **kwargs)
            _wait(func, again)
            for kept, new in zip(tree_leaves(out), tree_leaves(again)):
                # A view or an in-place result shares the kept storage; a
                # kept tensor may have been reshaped in place since (the
                # vector-matrix product squeezes its mm's output).
                if (isinstance(kept, torch.Tensor) and kept.untyped_storage().data_ptr()
                        != new.untyped_storage().data_ptr()):
                    kept.copy_(new.reshape(kept.shape))


@contextlib.contextmanager
def recording_graphs():
    """``simplex.graphs`` with ``RecordingGraph`` as its graph type and the
    CPU among the captured devices, its caches of chunks and steps empty,
    inside the block; as it was after it."""
    from relp_tpu_torch.simplex import graphs

    kept = (graphs.Graph, graphs.DEVICE_TYPES, graphs._CHUNKS, graphs._STEPS,
            graphs._GROUP_STEPS)
    graphs.Graph, graphs.DEVICE_TYPES = RecordingGraph, ("cuda", "cpu")
    graphs._CHUNKS, graphs._STEPS, graphs._GROUP_STEPS = None, None, {}
    try:
        yield
    finally:
        (graphs.Graph, graphs.DEVICE_TYPES, graphs._CHUNKS, graphs._STEPS,
         graphs._GROUP_STEPS) = kept
