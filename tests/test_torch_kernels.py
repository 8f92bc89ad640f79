"""The port's simplex kernels against the JAX package's, in f64 on the CPU.

Each package builds the problem with its own classes from the same source
(``twin``) and lowers it with its own ``lower_provider`` (f64, pad_to=8);
the lowered arrays must be equal.  Both start from the same state
(``state_from_numpy`` of the JAX state) and run chunk by chunk.  After every chunk ``basis``, ``iteration``,
``status`` and the other integer fields must be identical, and the float
fields (Binv, xB, pi, obj, gamma, d) equal to rtol 1e-12, with an absolute
floor of 1e-12 * (1 + max|field|) for entries at rounding level near zero.

Integer data makes exact ratio ties common and the two packages sum in
different orders, so a pivot sequence may split at a tie.  When that happens
the test replays the chunk pivot by pivot, requires the split to be a tie
within 1e-12 relative, and requires both walks to end in the same verdict
with the same objective.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import relp_tpu_torch.testing
import tests.test_fuzz_differential
from relp_tpu.config import SolverConfig as JaxConfig
from relp_tpu.io import load_general_form as jax_load_general_form
from relp_tpu.simplex import kernels as jk
from relp_tpu.simplex import state as jstate
from relp_tpu.simplex.driver import _drive_out_artificials
from relp_tpu.simplex.engine import DenseEngine as JaxEngine
from relp_tpu.simplex.lowering import lower_provider as jax_lower_provider
from relp_tpu.simplex.result import SolveStats as JaxSolveStats
from relp_tpu_torch.io import load_general_form
from relp_tpu_torch.simplex import kernels as tk
from relp_tpu_torch.simplex import state as tstate
from relp_tpu_torch.simplex.lowering import lower_provider
from relp_tpu_torch.simplex.state import state_from_numpy, state_to_numpy
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_host_copy import twin

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL = 1e-9
CHUNK = 50
MIN_PIVOTS = 200
FLOAT_FIELDS = ("Binv", "xB", "pi", "obj", "gamma", "d")
INT_FIELDS = ("basis", "iteration", "status", "in_basis", "degen_count",
              "inner", "price_start")


ARRAYS = ("A", "b", "c_phase1", "c_phase2", "candidate_mask")


def _lowered(name, port):
    """The named problem built and lowered by one package."""
    if name == "knap6":
        load = load_general_form if port else jax_load_general_form
        gf = load(os.path.join(DATA, "knap6.mps"))
        gf.presolve()
    elif name.startswith("fuzz"):
        fuzz = (twin("tests.test_fuzz_differential") if port
                else tests.test_fuzz_differential)
        gf, _ = fuzz._random_instance(np.random.default_rng(int(name[4:])))
    else:  # "lp{m}x{n}": the generated LP of relp_tpu_torch.testing
        testing = (relp_tpu_torch.testing if port
                   else twin("relp_tpu_torch.testing", "relp_tpu"))
        m, n = (int(v) for v in name[2:].split("x"))
        gf = testing.generated_lp(m, n, 7)
        gf.presolve()
    lower = lower_provider if port else jax_lower_provider
    return lower(gf.derive_matrix_data(gf.standardize()), dtype=np.float64, pad_to=8)


class Pair:
    """The same problem lowered by each package, as JAX arrays and as torch
    tensors."""

    def __init__(self, name):
        self.problem = _lowered(name, port=True)
        self.problem_j = _lowered(name, port=False)
        for k in (*ARRAYS, "initial_basis"):
            assert np.array_equal(getattr(self.problem, k),
                                  getattr(self.problem_j, k)), k
        self.j = {k: jnp.asarray(getattr(self.problem_j, k)) for k in ARRAYS}
        self.t = {k: torch.from_numpy(np.asarray(getattr(self.problem, k)))
                  for k in ARRAYS}


def _init(pair):
    js = JaxEngine().init_state(pair.problem_j, JaxConfig(dtype="float64", pad_to=8))
    return js, state_from_numpy(js, "cpu")


def _np_state(js):
    return {k: np.asarray(getattr(js, k)) for k in jstate.SimplexState._fields}


def _mismatch(js, ts):
    """None when the states agree; else the first field that differs."""
    jn, tn = _np_state(js), state_to_numpy(ts)
    for k in INT_FIELDS:
        if not np.array_equal(jn[k], tn[k]):
            return k
    for k in FLOAT_FIELDS:
        floor = 1e-12 * (1.0 + float(np.abs(jn[k]).max(initial=0.0)))
        if not np.allclose(tn[k], jn[k], rtol=1e-12, atol=floor):
            return k
    return None


def _assert_same(js, ts, where):
    field = _mismatch(js, ts)
    if field is not None:
        jn, tn = _np_state(js), state_to_numpy(ts)
        np.testing.assert_allclose(
            tn[field], jn[field], rtol=1e-12,
            err_msg=f"{field} differs {where}",
        )
        raise AssertionError(f"{field} differs {where}")


def _chunk_kw(pricing, stop_at_zero):
    return dict(pricing=pricing, opt_tol=TOL, pivot_tol=TOL, degen_tol=TOL,
                stop_at_zero=stop_at_zero)


def _run_jax(js, pair, c, pricing, chunk, stop_at_zero):
    A = pair.j["A"]
    return jk.run_chunk(js, A, A, pair.j[c], pair.j["candidate_mask"],
                        chunk=chunk, **_chunk_kw(pricing, stop_at_zero))


def _run_torch(ts, pair, c, pricing, chunk, stop_at_zero):
    A = pair.t["A"]
    return tk.run_chunk(ts, A, A, pair.t[c], pair.t["candidate_mask"],
                        chunk=chunk, **_chunk_kw(pricing, stop_at_zero))


def _done(js, stop_at_zero):
    return int(js.status) != jstate.RUNNING or (
        stop_at_zero and float(js.obj) <= 1e-9
    )


def _tie(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-300)


def _explain_split(js, ts, pair, c, pricing):
    """Replay one chunk pivot by pivot from agreeing entry states and show
    that the first pivot where the packages part is a tie; return the
    states right after it."""
    A_j, A_t = pair.j["A"], pair.t["A"]
    js = js._replace(inner=jnp.zeros((), jnp.int32),
                     d=pair.j[c] - js.pi @ A_j)
    ts = ts._replace(inner=torch.zeros((), dtype=torch.int32),
                     d=pair.t[c] - ts.pi @ A_t)
    step_j = jk.make_iteration(pricing, TOL, TOL, TOL)
    step_t = tk.make_iteration(pricing, TOL, TOL, TOL)
    for _ in range(CHUNK):
        nj = step_j(js, A_j, A_j, pair.j[c], pair.j[c], pair.j["candidate_mask"])
        nt = step_t(ts, A_t, A_t, pair.t[c], pair.t[c], pair.t["candidate_mask"])
        bj, bt = np.asarray(nj.basis), nt.basis.numpy()
        if np.array_equal(bj, bt):
            _assert_same(nj, nt, "during the replay")
            js, ts = nj, nt
            if int(nj.status) != jstate.RUNNING:
                break
            continue
        s = _np_state(js)
        rows = np.flatnonzero(bj != s["basis"])
        rows_t = np.flatnonzero(bt != s["basis"])
        q_j, q_t = int(bj[rows[0]]), int(bt[rows_t[0]])
        eligible = (np.asarray(pair.problem.candidate_mask) & ~s["in_basis"]
                    & (s["d"] < -TOL))
        if q_j != q_t:
            d, g = s["d"], s["gamma"]
            score = {
                jk.PRICE_STEEPEST: d * d / g, jk.PRICE_DANTZIG: -d,
            }.get(pricing)
            if score is not None:
                assert eligible[q_j] and eligible[q_t]
                assert _tie(score[q_j], score[q_t]), (q_j, q_t, score[q_j], score[q_t])
            else:  # first-eligible rules part only at the eligibility edge
                assert any(_tie(s["d"][q], -TOL) for q in (q_j, q_t))
        else:
            w = s["Binv"] @ pair.problem.A[:, q_j]
            r_j, r_t = int(rows[0]), int(rows_t[0])
            xb = np.maximum(s["xB"], 0.0)
            ratio_j, ratio_t = xb[r_j] / w[r_j], xb[r_t] / w[r_t]
            assert _tie(w[r_j], w[r_t]) or _tie(ratio_j, ratio_t), (
                r_j, r_t, w[r_j], w[r_t], ratio_j, ratio_t,
            )
        return nj, nt
    raise AssertionError("the chunk split but its replay did not")


def _walk(pair, js, ts, c, pricing, stop_at_zero, budget):
    """Chunks in lockstep until terminal or ``budget`` pivots; on a split,
    prove the tie and finish both walks independently.  Returns the final
    (js, ts, split)."""
    while not _done(js, stop_at_zero) and int(js.iteration) < budget:
        nj = _run_jax(js, pair, c, pricing, CHUNK, stop_at_zero)
        nt = _run_torch(ts, pair, c, pricing, CHUNK, stop_at_zero)
        if _mismatch(nj, nt) in ("basis", "iteration", "status", "in_basis"):
            js, ts = _explain_split(js, ts, pair, c, pricing)
            for _ in range(200):
                if _done(js, stop_at_zero) and _done(ts, stop_at_zero):
                    break
                js = _run_jax(js, pair, c, pricing, CHUNK, stop_at_zero)
                ts = _run_torch(ts, pair, c, pricing, CHUNK, stop_at_zero)
            assert int(js.status) == int(ts.status)
            np.testing.assert_allclose(float(ts.obj), float(js.obj), rtol=1e-9,
                                       atol=1e-9)
            return js, ts, True
        _assert_same(nj, nt, f"after pivot {int(nj.iteration)}")
        js, ts = _refresh_gamma(nj, nt, pair, pricing)
    return js, ts, False


def _refresh_gamma(js, ts, pair, pricing):
    """Fresh steepest-edge weights in each package, as the driver computes
    them at every chunk exit: the in-chunk Goldfarb update cancels, so two
    summation orders drift apart by ~1e-10 relative over a few hundred
    pivots without it."""
    if pricing == jk.PRICE_STEEPEST:
        js = js._replace(gamma=jk.recompute_gamma(js.Binv, pair.j["A"], js.in_basis))
        ts = ts._replace(gamma=tk.recompute_gamma(ts.Binv, pair.t["A"], ts.in_basis))
    return js, ts


def _two_phases(name, pricing):
    pair = Pair(name)
    js, ts = _init(pair)
    split = False
    for c, stop_at_zero in (("c_phase1", True), ("c_phase2", False)):
        js, ts = _refresh_gamma(js, ts, pair, pricing)
        _assert_same(js, ts, "after recompute_gamma")
        js, ts, split_here = _walk(pair, js, ts, c, pricing, stop_at_zero,
                                   budget=int(js.iteration) + 20 * MIN_PIVOTS)
        split = split or split_here
        if split or c == "c_phase2":
            break
        # The driver's phase transition, done once by the JAX package so
        # both phase-2 walks start from one clean state: refactorize and
        # drive zero-level artificials out, refactorize for the real costs.
        engine, cfg = JaxEngine(), JaxConfig(dtype="float64", pad_to=8)
        args = (pair.j["A"], pair.j["b"], pair.j["c_phase1"], cfg, JaxSolveStats())
        js, _ = engine.refactor(js, *args)
        js, _ = _drive_out_artificials(engine, js, pair.problem_j, *args)
        js, _ = engine.refactor(js, pair.j["A"], pair.j["b"], pair.j["c_phase2"],
                                cfg, JaxSolveStats())
        js = js._replace(status=jnp.asarray(jstate.RUNNING, jnp.int32))
        ts = state_from_numpy(js, "cpu")
    return pair, js, ts, split


@pytest.mark.parametrize(
    "name", ["knap6", "fuzz0", "fuzz9", "fuzz10", "lp32x96", "lp64x256"]
)
def test_steepest_chunks_match_jax(name):
    _pair, js, ts, split = _two_phases(name, jk.PRICE_STEEPEST)
    assert int(js.status) == int(ts.status) == jstate.OPTIMAL
    if name == "lp64x256":
        assert int(js.iteration) >= MIN_PIVOTS


def _port_state(js):
    """The port's state from the JAX package's, whatever the dtype of d."""
    fields = {k: np.asarray(getattr(js, k)) for k in jstate.SimplexState._fields}
    fields["d"] = np.asarray(js.d.astype(jnp.float32))
    return state_from_numpy(fields, "cpu")._replace(
        d=torch.tensor(fields["d"]).to(getattr(torch, str(js.d.dtype))))


@pytest.mark.parametrize("name", ["lp64x256", "knap6"])
def test_bf16_scan_chunks_match_jax_pivot_for_pivot(name):
    """The f64 carry with the scans on a bf16 copy of the tableau: both
    phases, chunk by chunk, the same entering column q and leaving row r at
    every pivot, the same chunk-entry d bit for bit, and each package's
    ``run_chunk`` ending where its pivot-by-pivot walk ends.  Every chunk
    starts from the JAX package's steepest-edge weights (recompute_gamma
    in bf16): its jitted form squares W in f32 and sums in blocks of 32
    rows, which its own eager form and the port round differently in the
    last bit, and one such bit parts lp64x256's walks after 231 pivots."""
    pair = Pair(name)
    js, _ts = _init(pair)
    A_j, A_t = pair.j["A"], pair.t["A"]
    scan_j, scan_t = A_j.astype(jnp.bfloat16), A_t.to(torch.bfloat16)
    mask_j, mask_t = pair.j["candidate_mask"], pair.t["candidate_mask"]
    step_j = jax.jit(jk.make_iteration(jk.PRICE_STEEPEST, TOL, TOL, TOL))
    step_t = tk.make_iteration(jk.PRICE_STEEPEST, TOL, TOL, TOL)
    pivots = 0
    for c, stop_at_zero in (("c_phase1", True), ("c_phase2", False)):
        c_j, c_t = pair.j[c], pair.t[c]
        kw = dict(chunk=CHUNK, **_chunk_kw(jk.PRICE_STEEPEST, stop_at_zero))
        for _ in range(100):
            if _done(js, stop_at_zero):
                break
            js = js._replace(gamma=jk.recompute_gamma(js.Binv, scan_j, js.in_basis))
            ts = _port_state(js)
            end_j = jk.run_chunk(js, scan_j, A_j, c_j, mask_j, **kw)
            end_t = tk.run_chunk(ts, scan_t, A_t, c_t, mask_t, **kw)
            js = js._replace(inner=jnp.zeros((), jnp.int32),
                             d=c_j.astype(jnp.bfloat16) - js.pi.astype(jnp.bfloat16) @ scan_j)
            ts = ts._replace(inner=torch.zeros((), dtype=torch.int32),
                             d=c_t.to(torch.bfloat16)
                             - torch.matmul(ts.pi.to(torch.bfloat16), scan_t))
            np.testing.assert_array_equal(ts.d.float().numpy(),
                                          np.asarray(js.d.astype(jnp.float32)))
            for _ in range(CHUNK):
                if _done(js, stop_at_zero):
                    break
                entry = np.asarray(js.basis)
                js = step_j(js, scan_j, A_j, c_j, c_j.astype(jnp.bfloat16), mask_j)
                ts = step_t(ts, scan_t, A_t, c_t, c_t.to(torch.bfloat16), mask_t)
                (r_j, q_j), (r_t, q_t) = (
                    (np.flatnonzero(basis != entry).tolist(), basis[basis != entry].tolist())
                    for basis in (np.asarray(js.basis), ts.basis.numpy()))
                assert (q_t, r_t) == (q_j, r_j), f"the walks part at pivot {pivots}"
                assert int(js.status) == int(ts.status)
                pivots = int(js.iteration)
            for end, walk in ((end_t, ts), (end_j, js)):
                assert np.array_equal(np.asarray(end.basis), np.asarray(walk.basis))
                assert int(end.iteration) == int(walk.iteration)
        assert _done(js, stop_at_zero)
        if c == "c_phase2":
            break
        engine, cfg = JaxEngine(), JaxConfig(dtype="float64", pad_to=8)
        args = (A_j, pair.j["b"], pair.j["c_phase1"], cfg, JaxSolveStats())
        js, _ = engine.refactor(js, *args)
        js, _ = _drive_out_artificials(engine, js, pair.problem_j, *args)
        js, _ = engine.refactor(js, A_j, pair.j["b"], pair.j["c_phase2"], cfg,
                                JaxSolveStats())
        js = js._replace(status=jnp.asarray(jstate.RUNNING, jnp.int32))
    assert int(js.status) == jstate.OPTIMAL
    np.testing.assert_allclose(float(ts.obj), float(js.obj), rtol=1e-12)
    if name == "lp64x256":
        assert pivots >= 2 * MIN_PIVOTS


@pytest.mark.parametrize(
    "pricing",
    [jk.PRICE_DANTZIG, jk.PRICE_BLAND, jk.PRICE_FIRST, jk.PRICE_FIRST_MEMORY],
)
def test_other_pricing_rules_match_jax(pricing):
    _pair, js, ts, split = _two_phases("lp32x96", pricing)
    assert int(js.iteration) >= MIN_PIVOTS
    assert int(js.status) == int(ts.status) == jstate.OPTIMAL


def test_constants_equal_the_jax_package():
    for name in ("RUNNING", "OPTIMAL", "UNBOUNDED", "SINGULAR", "INFEASIBLE"):
        assert getattr(tstate, name) == getattr(jstate, name), name
    for name in ("PRICE_DANTZIG", "PRICE_STEEPEST", "PRICE_BLAND",
                 "PRICE_FIRST", "PRICE_FIRST_MEMORY"):
        assert getattr(tk, name) == getattr(jk, name), name
    assert tk.noisy_f32_matmul() is False
    assert tstate.SimplexState._fields == jstate.SimplexState._fields


@pytest.mark.parametrize("M", [1, 8, 1000, 5248])
def test_rademacher_probes_are_bit_identical(M):
    # The JAX expression of kernels.py:636-641, in uint32 with wraparound.
    k = 4
    ij = (jax.lax.broadcasted_iota(jnp.uint32, (M, k), 0) * jnp.uint32(2654435761)
          + jax.lax.broadcasted_iota(jnp.uint32, (M, k), 1) * jnp.uint32(40503))
    V = np.asarray(jnp.where((ij >> 13) & 1, 1.0, -1.0).astype(jnp.float64))
    np.testing.assert_array_equal(tk.rademacher_probes(M, k, "cpu").numpy(), V)


@pytest.fixture(scope="module")
def phase1_state():
    """lp32x96 after 30 phase-1 pivots: a non-trivial basis, same in both."""
    pair = Pair("lp32x96")
    js, _ = _init(pair)
    js = _run_jax(js, pair, "c_phase1", jk.PRICE_STEEPEST, 30, True)
    assert int(js.iteration) == 30
    return pair, js


def test_refactorize_and_newton_refresh_match(phase1_state):
    pair, js = phase1_state
    args_j = (pair.j["A"], pair.j["b"], pair.j["c_phase2"], js.basis)
    args_t = (pair.t["A"], pair.t["b"], pair.t["c_phase2"],
              torch.from_numpy(np.array(js.basis)))
    out_j = jk.refactorize(*args_j, newton_steps=3)
    out_t = tk.refactorize(*args_t, newton_steps=3)
    for a, b in zip(out_t[:4], out_j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    assert float(out_t[4]) < 1e-12 and float(out_j[4]) < 1e-12

    Binv = np.array(js.Binv)
    ref_j = jk.newton_refresh(jnp.asarray(Binv), *args_j, steps=2)
    ref_t = tk.newton_refresh(torch.from_numpy(Binv), *args_t, steps=2)
    for a, b in zip(ref_t[:4], ref_j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    assert float(ref_t[4]) < 1e-12


def test_singular_refactorize_reports_nonfinite_or_large_residual():
    A = torch.tensor([[1.0, 2.0, 0.0], [2.0, 4.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float64)
    _, _, _, _, residual = tk.refactorize(
        A, torch.ones(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64),
        torch.tensor([0, 1, 2], dtype=torch.int32),
    )
    assert not (float(residual) <= 1e-4)


def test_carry_health_matches_on_an_f32_carry(phase1_state):
    pair, js = phase1_state
    # An f32 carry, as the driver measures it: its residuals are ~1e-7.
    f32 = {k: np.asarray(getattr(js, k)).astype(np.float32) for k in ("Binv", "xB", "pi")}
    A32 = {k: np.asarray(getattr(pair.problem, k)).astype(np.float32)
           for k in ("A", "b", "c_phase1")}
    basis = np.array(js.basis)
    h_j = float(jk.carry_health(
        jnp.asarray(f32["Binv"]), jnp.asarray(A32["A"]), jnp.asarray(A32["b"]),
        jnp.asarray(A32["c_phase1"]), jnp.asarray(basis), jnp.asarray(f32["xB"]),
        jnp.asarray(f32["pi"])))
    h_t = float(tk.carry_health(
        *(torch.from_numpy(x) for x in (f32["Binv"], A32["A"], A32["b"],
                                        A32["c_phase1"], basis, f32["xB"], f32["pi"]))))
    assert 0.0 < h_j < 1e-4
    np.testing.assert_allclose(h_t, h_j, rtol=1e-9)


def test_recompute_gamma_tableau_row_reduced_costs_match(phase1_state):
    pair, js = phase1_state
    ts = state_from_numpy(js, "cpu")
    A_j, A_t = pair.j["A"], pair.t["A"]
    np.testing.assert_allclose(
        tk.recompute_gamma(ts.Binv, A_t, ts.in_basis).numpy(),
        np.asarray(jk.recompute_gamma(js.Binv, A_j, js.in_basis)), rtol=1e-12)
    for r in (0, 3, pair.problem.M - 1):
        np.testing.assert_allclose(
            tk.tableau_row(ts.Binv, A_t, r).numpy(),
            np.asarray(jk.tableau_row(js.Binv, A_j, r)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tk.reduced_costs(ts.pi, A_t, pair.t["c_phase1"]).numpy(),
        np.asarray(jk.reduced_costs(js.pi, A_j, pair.j["c_phase1"])),
        rtol=1e-12, atol=1e-12)


def test_forced_pivot_matches(phase1_state):
    pair, js = phase1_state
    ts = state_from_numpy(js, "cpu")
    s = _np_state(js)
    r = 0
    row = s["Binv"][r] @ pair.problem.A
    candidates = np.flatnonzero(~s["in_basis"][: pair.problem.n_real]
                                & (np.abs(row[: pair.problem.n_real]) > 1e-7))
    q = int(candidates[np.argmax(np.abs(row[candidates]))])
    nj = jk.forced_pivot(js, pair.j["A"], pair.j["c_phase1"], q, r)
    nt = tk.forced_pivot(ts, pair.t["A"], pair.t["c_phase1"], q, r)
    _assert_same(nj, nt, "after forced_pivot")
    assert int(nt.basis[r]) == q


def test_dual_chunks_match_after_rhs_change():
    """Optimal basis, then a changed right-hand side: dual pivots restore
    primal feasibility in both packages, chunk by chunk."""
    pair = Pair("lp32x96")
    _pair, js, _ts, split = _two_phases("lp32x96", jk.PRICE_STEEPEST)
    assert not split and int(js.status) == jstate.OPTIMAL
    p = pair.problem
    rng = np.random.default_rng(3)
    b2 = p.b.copy()
    b2[: p.m_real] += rng.integers(-3, 2, size=p.m_real)
    X, xB, pi, obj, _res = jk.refactorize(
        pair.j["A"], jnp.asarray(b2), pair.j["c_phase2"], js.basis, newton_steps=3)
    js = js._replace(Binv=X, xB=xB, pi=pi, obj=obj,
                     status=jnp.asarray(jstate.RUNNING, jnp.int32))
    assert float(js.xB.min()) < -1e-6  # primal infeasible now
    ts = state_from_numpy(js, "cpu")
    for _ in range(40):
        kw = dict(chunk=5, opt_tol=TOL, pivot_tol=TOL, feas_tol=TOL)
        js = jk.dual_run_chunk(js, pair.j["A"], pair.j["A"], pair.j["c_phase2"],
                               pair.j["candidate_mask"], **kw)
        ts = tk.dual_run_chunk(ts, pair.t["A"], pair.t["A"], pair.t["c_phase2"],
                               pair.t["candidate_mask"], **kw)
        _assert_same(js, ts, f"after dual pivot {int(js.iteration)}")
        if int(js.status) != jstate.RUNNING:
            break
    assert int(js.status) in (jstate.OPTIMAL, jstate.INFEASIBLE)
    assert int(ts.iteration) > int(_ts.iteration)


def test_single_iterations_match(phase1_state):
    """make_iteration / make_dual_iteration one step, as the JAX closures."""
    pair, js = phase1_state
    js = js._replace(status=jnp.asarray(jstate.RUNNING, jnp.int32))
    ts = state_from_numpy(js, "cpu")
    A_j, A_t, c_j, c_t = pair.j["A"], pair.t["A"], pair.j["c_phase1"], pair.t["c_phase1"]
    m_j, m_t = pair.j["candidate_mask"], pair.t["candidate_mask"]
    for pricing in (jk.PRICE_STEEPEST, jk.PRICE_DANTZIG, jk.PRICE_FIRST_MEMORY):
        nj = jax.jit(jk.make_iteration(pricing, TOL, TOL, TOL))(js, A_j, A_j, c_j, c_j, m_j)
        nt = tk.make_iteration(pricing, TOL, TOL, TOL)(ts, A_t, A_t, c_t, c_t, m_t)
        _assert_same(nj, nt, f"after one iteration, pricing {pricing}")
    nj = jax.jit(jk.make_dual_iteration(TOL, TOL, TOL))(js, A_j, A_j, c_j, c_j, m_j)
    nt = tk.make_dual_iteration(TOL, TOL, TOL)(ts, A_t, A_t, c_t, c_t, m_t)
    _assert_same(nj, nt, "after one dual iteration")


def test_state_round_trip_is_exact(phase1_state):
    _pair, js = phase1_state
    back = state_to_numpy(state_from_numpy(js, "cpu"))
    for k, v in _np_state(js).items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
