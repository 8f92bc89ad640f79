"""The port's LU + eta engine against the JAX package's, on the CPU.

* The FTRAN/BTRAN identities of tests/test_lu_backend.py (against a dense
  inverse, before and after two etas enter the ring), and the port's
  solves against the JAX package's from one state.
* The pivot convention: JAX's 0-based LAPACK swaps become torch's 1-based
  ones in ``state_from_numpy`` and back in ``state_to_numpy``, and both
  packages' ``lu_refactorize`` choose the same pivots.
* In f64, two-phase walks chunk by chunk, each chunk from the JAX
  package's refactorized state: the same pivot sequence over at least 200
  pivots (basis, in_basis, status, iteration, eta count and rows identical
  after every chunk).  On a transportation LP (a totally unimodular
  matrix, integer data) every factor, solve and eta is exact in f32 and
  f64, so xB, pi, obj, gamma and the live eta columns must agree within
  1e-10 relative to 1 + max|field|.  On Gaussian data the two packages'
  f32 triangular solves (two BLAS libraries) differ in the last bits, and
  one refinement step leaves that at about (eps32 * cond(B))^2: up to
  ~1e-7 at the bases these walks visit, so the float fields are held to
  1e-6 there while the pivot sequence must still be the same.
* An iteration masked off (phase over, ring full) changes nothing: the
  CUDA chunk runs its fixed length under that mask.
* Exact verdicts and Fraction objectives equal at f32 and f64 with
  ``basis_inverse="lu"`` on the driver-test cases (phase-1 artificials and
  rank repair included) and fuzz instances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relp_tpu.config import SolverConfig as JaxConfig
from relp_tpu.simplex import lu as jlu
from relp_tpu.simplex.engine import LUEngine as JaxLUEngine
from relp_tpu.simplex.kernels import PRICE_DANTZIG, PRICE_STEEPEST
from relp_tpu.simplex.result import SolveStats as JaxSolveStats
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.linalg.device import pad_to_multiple
from relp_tpu_torch.simplex import lu as tlu
from relp_tpu_torch.simplex import solve_general_form
from relp_tpu_torch.simplex.engine import LUEngine
from relp_tpu_torch.simplex.result import SolveStats
from relp_tpu_torch.simplex.state import OPTIMAL, RUNNING
from relp_tpu_torch.testing import synthetic_problem
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_driver import PORT, SIMPLEX_SMALL, _both

LU = dict(pad_to=8, chunk_size=20, refactor_period=20, basis_inverse="lu")
INT_FIELDS = ("basis", "in_basis", "status", "iteration", "eta_count")
FLOAT_FIELDS = ("xB", "pi", "obj", "gamma", "eta_vals")


def _jax_state(A, b, c, basis, capacity):
    """A JAX LUState at ``basis`` (lu_refactorize on the JAX side)."""
    M, N = A.shape
    lu, piv, B0, ev, er, xB, pi, obj, _res = jlu.lu_refactorize(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), jnp.asarray(basis),
        eta_capacity=capacity,
    )
    in_basis = np.zeros(N, dtype=bool)
    in_basis[basis] = True
    zero = jnp.zeros((), jnp.int32)
    return jlu.LUState(
        lu=lu, piv=piv, B0=B0, eta_vals=ev, eta_rows=er, eta_count=zero,
        basis=jnp.asarray(basis), xB=xB, pi=pi, obj=obj,
        in_basis=jnp.asarray(in_basis), gamma=jnp.ones(N, dtype=A.dtype),
        iteration=zero, status=jnp.asarray(RUNNING, jnp.int32), inner=zero,
        price_start=zero,
    )


def _identity_problem(M=24):
    rng = np.random.default_rng(42)
    A = rng.standard_normal((M, 2 * M))
    b = np.abs(rng.standard_normal(M))
    c = rng.standard_normal(2 * M)
    return rng, A, b, c, np.arange(M, dtype=np.int32)


def test_lu_ftran_btran_identities():
    """B^-1 column/row identities through factors + eta ring, and the
    port's solves equal the JAX package's from one state."""
    rng, A, b, c, basis = _identity_problem()
    M = A.shape[0]
    js = _jax_state(A, b, c, basis, capacity=8)
    ts = tlu.state_from_numpy(js, "cpu")
    B = A[:, :M]
    Binv = np.linalg.inv(B)
    for k in (0, 7, M - 1):
        e = np.zeros(M)
        e[k] = 1.0
        x = tlu.lu_ftran(ts, torch.as_tensor(e), 0).numpy()
        assert np.allclose(x, Binv[:, k], atol=1e-9)
        np.testing.assert_allclose(x, np.asarray(jlu.lu_ftran(js, jnp.asarray(e))),
                                   rtol=0, atol=1e-11)
    y = rng.standard_normal(M)
    v = tlu.lu_btran(ts, torch.as_tensor(y), 0).numpy()
    assert np.allclose(v, y @ Binv, atol=1e-8)
    np.testing.assert_allclose(v, np.asarray(jlu.lu_btran(js, jnp.asarray(y))),
                               rtol=0, atol=1e-11)

    # Two product-form etas: against the inverse of the twice-updated basis.
    q1, r1, q2, r2 = M + 3, 5, M + 11, 17
    w1 = Binv @ A[:, q1]
    B2 = B.copy()
    B2[:, r1] = A[:, q1]
    w2 = np.linalg.inv(B2) @ A[:, q2]
    B3 = B2.copy()
    B3[:, r2] = A[:, q2]
    ev = np.zeros((8, M))
    ev[0], ev[1] = w1, w2
    er = np.zeros(8, dtype=np.int32)
    er[0], er[1] = r1, r2
    js = js._replace(eta_vals=jnp.asarray(ev), eta_rows=jnp.asarray(er),
                     eta_count=jnp.asarray(2, jnp.int32))
    ts = tlu.state_from_numpy(js, "cpu")
    B3inv = np.linalg.inv(B3)
    a = A[:, M + 9]
    for steps in (2, 5, 8):  # slots past the live count are identities
        x = tlu.lu_ftran(ts, torch.as_tensor(a), steps).numpy()
        assert np.allclose(x, B3inv @ a, atol=1e-8)
        np.testing.assert_allclose(x, np.asarray(jlu.lu_ftran(js, jnp.asarray(a))),
                                   rtol=0, atol=1e-11)
        v = tlu.lu_btran(ts, torch.as_tensor(y), steps).numpy()
        assert np.allclose(v, y @ B3inv, atol=1e-7)
        np.testing.assert_allclose(v, np.asarray(jlu.lu_btran(js, jnp.asarray(y))),
                                   rtol=0, atol=1e-11)


def test_pivots_convert_between_the_packages():
    """0-based JAX swaps <-> 1-based torch swaps; both LUs pick the same
    pivots, and a state goes through the port and back bit for bit."""
    _rng, A, b, c, basis = _identity_problem(40)
    js = _jax_state(A, b, c, basis, capacity=4)
    ts = tlu.state_from_numpy(js, "cpu")
    M = A.shape[0]  # the last row can only swap with itself
    assert int(np.asarray(js.piv)[-1]) == M - 1 and int(ts.piv[-1]) == M
    back = tlu.state_to_numpy(ts)
    for name in tlu.LUState._fields:
        assert np.array_equal(back[name], np.asarray(getattr(js, name))), name
    mine = tlu.lu_refactorize(torch.as_tensor(A), torch.as_tensor(b), torch.as_tensor(c),
                              torch.as_tensor(basis), eta_capacity=4)
    assert torch.equal(mine[1], ts.piv)
    # f32 factors of two LAPACKs: equal to f32 rounding of the growth
    scale = 1.0 + float(np.abs(np.asarray(js.lu)).max())
    np.testing.assert_allclose(mine[0].numpy(), np.asarray(js.lu), rtol=0, atol=1e-5 * scale)
    assert float(mine[8]) < 1e-8  # after one refinement step; the driver refuses >= 1e-4


def _transportation(S, D, seed, pad=32):
    """The transportation LP from S sources to D sinks in the lowered format
    of ``synthetic_problem``: rows are the S supplies and D demands (equal
    totals), columns the S*D arcs, then one artificial per padded row;
    integer supplies, demands and costs."""
    rng = np.random.default_rng(seed)
    m, n = S + D, S * D
    M = pad_to_multiple(m, pad)
    N = pad_to_multiple(n + M, pad)
    A = np.zeros((M, N))
    arcs = np.arange(n)
    A[arcs // D, arcs] = 1.0
    A[S + arcs % D, arcs] = 1.0
    A[np.arange(M), n + np.arange(M)] = 1.0
    supply = rng.integers(5, 40, size=S)
    cuts = np.sort(rng.choice(np.arange(1, supply.sum()), size=D - 1, replace=False))
    b = np.zeros(M)
    b[:S] = supply
    b[S:m] = np.diff(np.concatenate([[0], cuts, [supply.sum()]]))
    c1 = np.zeros(N)
    c1[n:n + m] = 1.0
    c2 = np.zeros(N)
    c2[:n] = rng.integers(1, 60, size=n)
    cand = np.zeros(N, dtype=bool)
    cand[:n] = True
    return A, b, c1, c2, cand, np.arange(n, n + M, dtype=np.int32)


def _problem(kind, seed):
    if kind == "transportation":
        A, b, c1, c2, cand, basis = _transportation(32, 64, seed)
    else:
        A, b, c1, c2, cand, basis = synthetic_problem(m=96, n=384, pad=32, seed=seed,
                                                       dtype=np.float64)
    j = {k: jnp.asarray(v) for k, v in dict(A=A, b=b, c1=c1, c2=c2, cand=cand).items()}
    t = {k: torch.as_tensor(v) for k, v in dict(A=A, b=b, c1=c1, c2=c2, cand=cand).items()}
    return j, t, basis


def _assert_same(js, ts, where, tol=1e-10):
    jn = {k: np.asarray(getattr(js, k)) for k in tlu.LUState._fields}
    tn = tlu.state_to_numpy(ts)
    for k in INT_FIELDS:
        assert np.array_equal(tn[k], jn[k]), f"{k} differs {where}"
    live = int(jn["eta_count"])
    assert np.array_equal(tn["eta_rows"][:live], jn["eta_rows"][:live]), where
    tn["eta_vals"], jn["eta_vals"] = tn["eta_vals"][:live], jn["eta_vals"][:live]
    for k in FLOAT_FIELDS:
        scale = 1.0 + float(np.abs(jn[k]).max(initial=0.0))
        err = float(np.abs(tn[k] - jn[k]).max(initial=0.0))
        assert err <= tol * scale, f"{k} differs {where}: {err:.3e}"


def _walk(pricing, kind, seed, tol):
    """Both phases, chunk by chunk from one state: at every chunk entry the
    JAX package refactorizes (and refreshes gamma), and the port starts from
    that state.  Two LAPACKs' f32 factors differ in the last bits, which the
    one refinement step leaves at ~1e-9 relative in xB; handing the port the
    same factors isolates the chunk (FTRAN/BTRAN, ring, pivot rules).  The
    port's own refactorization is held to the JAX one separately (the
    identities above) and end to end (the driver cases below).  Returns the
    pivot count."""
    j, t, basis = _problem(kind, seed)
    cfg_j = JaxConfig(dtype="float64", pad_to=32, chunk_size=20, refactor_period=20,
                      basis_inverse="lu")
    eng_j = JaxLUEngine()
    js = _jax_state(np.asarray(j["A"]), np.asarray(j["b"]), np.asarray(j["c1"]),
                    basis, capacity=20)
    kw = dict(pricing=pricing, chunk=20, opt_tol=1e-9, pivot_tol=1e-9, degen_tol=1e-9)
    for c, stop_at_zero in (("c1", True), ("c2", False)):
        js = js._replace(status=jnp.asarray(RUNNING, jnp.int32))
        for _ in range(200):
            js, _ = eng_j.refactor(js, j["A"], j["b"], j[c], cfg_j, JaxSolveStats())
            if pricing == PRICE_STEEPEST:
                js = eng_j.recompute_gamma(js, j["A"])
            ts = tlu.state_from_numpy(js, "cpu")
            js = jlu.lu_run_chunk(js, j["A"], j["A"], j[c], j["cand"],
                                  stop_at_zero=stop_at_zero, **kw)
            ts = tlu.lu_run_chunk(ts, t["A"], t["A"], t[c], t["cand"],
                                  stop_at_zero=stop_at_zero, **kw)
            _assert_same(js, ts, f"after pivot {int(js.iteration)}", tol)
            if int(js.status) != RUNNING or (stop_at_zero and float(js.obj) <= 1e-9):
                break
        if c == "c1":
            assert float(js.obj) <= 1e-9, "phase 1 did not reach zero"
    assert int(js.status) != RUNNING
    return int(js.iteration)


@pytest.mark.parametrize("kind,seed,tol", [("transportation", 1, 1e-10),
                                           ("gaussian", 3, 1e-6)])
@pytest.mark.parametrize("pricing", [PRICE_STEEPEST, PRICE_DANTZIG])
def test_lu_walk_matches_jax(pricing, kind, seed, tol):
    assert _walk(pricing, kind, seed, tol) >= 200


@pytest.mark.parametrize("why", ["optimal", "ring_full", "inactive"])
def test_an_inactive_iteration_changes_nothing(why):
    """On CUDA a chunk runs all its iterations under a device-side mask
    (the CPU loop stops instead): an iteration after the phase ended, with
    a full ring, or masked off, must leave every field but ``inner``
    (which counts active iterations) as it was, and write no ring slot."""
    j, t, basis = _problem("gaussian", 1)
    js = _jax_state(np.asarray(j["A"]), np.asarray(j["b"]), np.asarray(j["c2"]),
                    basis, capacity=4)
    ts = tlu.state_from_numpy(js, "cpu")
    if why == "optimal":
        ts = ts._replace(status=torch.tensor(OPTIMAL, dtype=torch.int32))
    if why == "ring_full":
        ts = ts._replace(eta_count=torch.tensor(4, dtype=torch.int32),
                         eta_vals=torch.ones_like(ts.eta_vals))
    active = torch.tensor(False) if why != "ring_full" else ts.eta_count < 4
    before = tlu.state_to_numpy(ts)
    out = tlu._lu_iteration(
        ts._replace(eta_vals=ts.eta_vals.clone(), eta_rows=ts.eta_rows.clone()),
        t["A"], t["A"], t["c2"], t["c2"], t["cand"], active, 4,
        pricing=PRICE_STEEPEST, opt_tol=1e-9, pivot_tol=1e-9,
    )
    after = tlu.state_to_numpy(out)
    for name in tlu.LUState._fields:
        assert np.array_equal(after[name], before[name]), name


def test_forced_pivot_and_tableau_row_match_jax():
    """The drive-out's two engine calls from one state with a live eta."""
    from relp_tpu.simplex.engine import _lu_forced_pivot as jax_forced
    from relp_tpu_torch.simplex.engine import _lu_forced_pivot

    j, t, basis = _problem("gaussian", 1)
    js = _jax_state(np.asarray(j["A"]), np.asarray(j["b"]), np.asarray(j["c1"]),
                    basis, capacity=8)
    for q, r in ((3, 5), (10, 2)):
        js = jax_forced(js, j["A"], j["c1"], q, r)
    ts = tlu.state_from_numpy(js, "cpu")
    assert int(ts.eta_count) == 2
    row_j = JaxLUEngine().tableau_row(js, j["A"], 7)
    row_t = LUEngine(torch.device("cpu")).tableau_row(ts, t["A"], 7)
    np.testing.assert_allclose(row_t, row_j, rtol=0, atol=1e-11)
    js, ts = jax_forced(js, j["A"], j["c1"], 20, 7), _lu_forced_pivot(ts, t["A"], t["c1"], 20, 7)
    _assert_same(js, ts, "after a forced pivot")


DRIVER_CASES = sorted(SIMPLEX_SMALL)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("name", DRIVER_CASES)
def test_lu_driver_cases_match_jax(name, dtype):
    build, overrides = SIMPLEX_SMALL[name]
    options = {**overrides, **{k: v for k, v in LU.items() if k not in overrides
                               or k == "basis_inverse"}}
    jax_verdict, port_verdict = _both(build, options, dtype)
    assert port_verdict == jax_verdict


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("seed", range(6))
def test_lu_fuzz_instances_match_jax(seed, dtype):
    build = lambda p: p.random_instance(np.random.default_rng(seed))[0]  # noqa: E731
    jax_verdict, port_verdict = _both(build, LU, dtype)
    assert port_verdict == jax_verdict


def test_lu_engine_runs_on_cuda_by_default():
    """platform=None means CUDA: without a card the LU path raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_general_form(SIMPLEX_SMALL["basic_max_lp"][0](PORT),
                           SolverConfig(**LU))
