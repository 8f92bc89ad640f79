"""The port's double-float carry against the JAX package's, on the CPU.

* The error-free transforms, ``df_add``/``mul``/``div`` and
  ``df_matvec``/``vecmat``/``dot``/``reduce_sum`` (odd and even lengths):
  the same f32 inputs, made from a seed with numpy, give the JAX package's
  hi and lo bits exactly (its functions run op by op, as written).  Under
  ``jax.jit`` XLA's CPU compiler contracts some ``e + x * y`` into an FMA
  (in ``df_mul``, ``df_mul_f``, ``df_div`` and the wide reductions), which
  moves the last bit of lo in a few lanes: there the jitted functions are
  held to the bits where they are EFTs proper (``two_sum``,
  ``fast_two_sum``, ``two_prod``, ``df_add``/``sub``) and elsewhere to
  hi + lo within 2^-46 relative.
* ``df_run_chunk`` from the same lowered problem (f64, split hi/lo) on
  knap6 and on problem_1 of tests/test_pipeline_problem1.py: the same
  (entering q, leaving r) sequence pivot by pivot, and after one whole
  chunk the same basis and iteration count with the carry (hi + lo in f64)
  within 1e-12 relative.
* ``carry="df32"`` solves: the JAX package's verdict and Fraction
  objective on knap6, problem_1/2 and three seeds of the fuzz generator.
* ``carry="df32"`` with a mesh raises ``ValueError`` in both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relp_tpu.config import SolverConfig as JaxConfig
from relp_tpu.io import load_general_form as jax_load_general_form
from relp_tpu.io import mps_to_general_form as jax_mps_to_general_form
from relp_tpu.io import parse_free as jax_parse_free
from relp_tpu.ops import df32 as jdf
from relp_tpu.simplex import df_kernels as jdk
from relp_tpu.simplex import solve_general_form as jax_solve_general_form
from relp_tpu.simplex import solve_relaxation as jax_solve_relaxation
from relp_tpu.simplex.engine import DoubleFloatEngine as JaxDfEngine
from relp_tpu.simplex.lowering import lower_provider as jax_lower_provider
from relp_tpu_torch.config import SolverConfig
from relp_tpu_torch.io import load_general_form, mps_to_general_form, parse_free
from relp_tpu_torch.ops import df32 as tdf
from relp_tpu_torch.simplex import df_kernels as tdk
from relp_tpu_torch.simplex import solve_general_form, solve_relaxation
from relp_tpu_torch.simplex.engine import DoubleFloatEngine, make_engine
from relp_tpu_torch.simplex.lowering import lower_provider
from tests.test_pipeline_problem1 import MPS_LITERAL
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_driver import JAX, PORT, SIMPLEX_SMALL, _verdict

DATA = os.path.join(os.path.dirname(__file__), "data")
DF32 = dict(carry="df32", pad_to=8)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _same_bits(jax_out, port_out):
    for j, t in zip(jax_out, port_out):
        assert np.array_equal(_bits(j), _bits(t.numpy())), (
            np.asarray(j), t.numpy())


def _same_value(jax_out, port_out, scale=None):
    """hi + lo in f64 within 2^-46 relative to 1 + ``scale`` (|value| by
    default; a sum's magnitude before cancellation for the reductions)."""
    j = np.asarray(jax_out[0], np.float64) + np.asarray(jax_out[1], np.float64)
    t = port_out[0].double().numpy() + port_out[1].double().numpy()
    scale = np.abs(j) if scale is None else scale
    assert np.all(np.abs(t - j) <= 2.0**-46 * (1.0 + scale))


# Exact under jit as well: no product feeds an add outside an EFT.
JIT_BITWISE = {"two_sum", "fast_two_sum", "two_prod", "df_add", "df_sub"}


def _pairs(n, seed, lo_scale=1e-8):
    """hi/lo f32 pairs (hi Gaussian, lo a rounding-level term)."""
    rng = np.random.default_rng(seed)
    hi = rng.standard_normal(n).astype(np.float32) * np.float32(1e3)
    lo = (rng.standard_normal(n) * lo_scale).astype(np.float32)
    return hi, lo


EFTS = {
    "two_sum": lambda m, a, b, c, d: m.two_sum(a, b),
    "fast_two_sum": lambda m, a, b, c, d: m.fast_two_sum(a, c),
    "two_prod": lambda m, a, b, c, d: m.two_prod(a, c),
    "df_add": lambda m, a, b, c, d: m.df_add(a, b, c, d),
    "df_sub": lambda m, a, b, c, d: m.df_sub(a, b, c, d),
    "df_mul_f": lambda m, a, b, c, d: m.df_mul_f(a, b, c),
    "df_mul": lambda m, a, b, c, d: m.df_mul(a, b, c, d),
    "df_div": lambda m, a, b, c, d: m.df_div(a, b, c, d),
    "df_axpy": lambda m, a, b, c, d: m.df_axpy(a, b, c, d, b, a),
    "df_dot": lambda m, a, b, c, d: m.df_dot(a, b, c, d),
}


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("name", sorted(EFTS))
def test_elementwise_df_ops_give_jax_bits(name, jit):
    a, b = _pairs(4097, 1)
    c, d = _pairs(4097, 2)
    c = c / np.float32(7.0)  # |a| >= |c| mostly, fast_two_sum's domain aside
    fn = EFTS[name]
    jfn = (lambda *x: fn(jdf, *x))
    if jit:
        jfn = jax.jit(jfn)
    jax_out = jfn(*(jnp.asarray(v) for v in (a, b, c, d)))
    port_out = fn(tdf, *(torch.from_numpy(v) for v in (a, b, c, d)))
    if jit and name not in JIT_BITWISE:
        _same_value(jax_out, port_out)
    else:
        _same_bits(jax_out, port_out)


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 129, 1920])
def test_reductions_give_jax_bits(n, jit):
    """df_matvec, df_vecmat and df_reduce_sum (the pairwise fold with its
    zero pad on odd lengths) at odd and even lengths."""
    rng = np.random.default_rng(n)
    Mh = rng.standard_normal((n, n)).astype(np.float32)
    Ml = (rng.standard_normal((n, n)) * 1e-8).astype(np.float32)
    vh, vl = _pairs(n, n + 1)
    ops = {
        "matvec": lambda m, Mh, Ml, vh, vl: m.df_matvec(Mh, Ml, vh, vl),
        "vecmat": lambda m, Mh, Ml, vh, vl: m.df_vecmat(vh, vl, Mh, Ml),
        "reduce_rows": lambda m, Mh, Ml, vh, vl: m.df_reduce_sum(Mh, Ml, axis=0),
        "reduce_cols": lambda m, Mh, Ml, vh, vl: m.df_reduce_sum(Mh, Ml, axis=-1),
    }
    for name, fn in ops.items():
        jfn = (lambda *x, fn=fn: fn(jdf, *x))
        if jit:
            jfn = jax.jit(jfn)
        jax_out = jfn(*(jnp.asarray(v) for v in (Mh, Ml, vh, vl)))
        port_out = fn(tdf, *(torch.from_numpy(v) for v in (Mh, Ml, vh, vl)))
        if jit and name in ("matvec", "vecmat"):
            terms = np.abs(Mh.astype(np.float64)) if name == "matvec" else np.abs(Mh.T.astype(np.float64))
            _same_value(jax_out, port_out, terms @ np.abs(vh.astype(np.float64)))
        else:
            _same_bits(jax_out, port_out)


def test_eft_exactness_and_split_constant():
    """two_sum/two_prod are exact (hi + lo in f64 is the true result of the
    f32 inputs), and the split constant is an f32 tensor."""
    assert tdf._SPLIT.dtype == torch.float32 and float(tdf._SPLIT) == 4097.0
    a, _ = _pairs(4096, 3)
    b, _ = _pairs(4096, 4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    s, e = tdf.two_sum(ta, tb)
    assert s.dtype == torch.float32
    np.testing.assert_array_equal(
        s.double().numpy() + e.double().numpy(), a.astype(np.float64) + b)
    p, e = tdf.two_prod(ta, tb)
    np.testing.assert_array_equal(
        p.double().numpy() + e.double().numpy(), a.astype(np.float64) * b)


def test_df_from_f64_round_trips():
    x = np.random.default_rng(5).standard_normal(33) * 1e5
    hi, lo = tdf.df_from_f64(x)
    jhi, jlo = jdf.df_from_f64(x)
    _same_bits((jhi, jlo), (hi, lo))
    np.testing.assert_allclose(tdf.df_to_f64(hi, lo), x, rtol=1e-14)


# --- the df32 chunk ---


def _general_form(name, port):
    if name == "knap6":
        gf = (load_general_form if port else jax_load_general_form)(
            os.path.join(DATA, "knap6.mps"))
    else:  # problem_1
        gf = (mps_to_general_form(parse_free(MPS_LITERAL)) if port
              else jax_mps_to_general_form(jax_parse_free(MPS_LITERAL)))
    gf.presolve()
    return gf


def _lowered(name, port):
    gf = _general_form(name, port)
    lower = lower_provider if port else jax_lower_provider
    return lower(gf.derive_matrix_data(gf.standardize()), dtype=np.float64, pad_to=8)


def _df_arrays(problem, port):
    """(A, c, mask) as the driver places them for carry="df32"."""
    if port:
        split = lambda x: tdf.df_from_f64(x)  # noqa: E731
        A = tdk.DfMatrix(*split(problem.A))
        mask = torch.from_numpy(np.asarray(problem.candidate_mask))
    else:
        split = jdf.df_from_f64
        A = jdk.DfMatrix(*split(problem.A))
        mask = jnp.asarray(problem.candidate_mask)
    phase1 = bool(np.any(problem.initial_basis[: problem.m_real] >= problem.art_offset))
    c = (tdk.DfVec if port else jdk.DfVec)(
        *split(problem.c_phase1 if phase1 else problem.c_phase2))
    return A, c, mask, phase1


CARRY = ("Binv", "xB", "pi", "obj")
KW = dict(pricing=1, opt_tol=1e-9, pivot_tol=1e-8, degen_tol=1e-9)


def _run(package_state, arrays, port, chunk, stop_at_zero):
    A, c, mask, _ = arrays
    run = tdk.df_run_chunk if port else jdk.df_run_chunk
    return run(package_state, A.hi, A.hi, A.lo, c.hi, c.lo, mask, chunk=chunk,
               stop_at_zero=stop_at_zero, **KW)


def _carry64(state, name):
    hi = np.asarray(getattr(state, name), np.float64)
    lo = np.asarray(getattr(state, f"{name}_lo"), np.float64)
    return hi + lo


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", ["knap6", "problem_1"])
def test_df_run_chunk_walks_jax_pivots(name):
    pj, pt = _lowered(name, port=False), _lowered(name, port=True)
    assert np.array_equal(pj.A, pt.A) and np.array_equal(pj.b, pt.b)
    cfg_j, cfg_t = JaxConfig(**DF32), SolverConfig(platform="cpu", **DF32)
    arr_j, arr_t = _df_arrays(pj, port=False), _df_arrays(pt, port=True)
    stop = arr_j[3]

    def start():
        js = JaxDfEngine().init_state(pj, cfg_j)
        ts = DoubleFloatEngine(torch.device("cpu")).init_state(pt, cfg_t)
        engine_j = JaxDfEngine()
        js = engine_j.recompute_gamma(js, arr_j[0])
        ts = DoubleFloatEngine(torch.device("cpu")).recompute_gamma(ts, arr_t[0])
        return js, ts

    # Pivot by pivot (chunks of one): the (q, r) sequences agree.
    js, ts = start()
    seq_j, seq_t = [], []
    for _ in range(80):
        bj, bt = _np(js.basis).copy(), _np(ts.basis).copy()
        js = _run(js, arr_j, False, 1, stop)
        ts = _run(ts, arr_t, True, 1, stop)
        for before, state, seq in ((bj, js, seq_j), (bt, ts, seq_t)):
            r = np.flatnonzero(_np(state.basis) != before)
            if r.size:
                seq.append((int(_np(state.basis)[r[0]]), int(r[0])))
        if int(js.status) != 0 or int(ts.status) != 0:
            break
    assert seq_t == seq_j and len(seq_j) > 0
    assert int(ts.status) == int(js.status)

    # One whole chunk: the same pivots and the same carry.
    js, ts = start()
    js = _run(js, arr_j, False, 60, stop)
    ts = _run(ts, arr_t, True, 60, stop)
    assert int(ts.iteration) == int(js.iteration) == len(seq_j)
    assert np.array_equal(_np(ts.basis), _np(js.basis))
    assert np.array_equal(_np(ts.in_basis), _np(js.in_basis))
    for field in CARRY:
        j, t = _carry64(js, field), _carry64(ts, field)
        floor = 1e-12 * (1.0 + float(np.abs(j).max(initial=0.0)))
        np.testing.assert_allclose(t, j, rtol=1e-12, atol=floor, err_msg=field)
    np.testing.assert_allclose(_np(ts.gamma), _np(js.gamma), rtol=1e-5)


# --- carry="df32" solves ---


DF32_CASES = {
    "knap6": lambda p: (load_general_form if p is PORT else jax_load_general_form)(
        os.path.join(DATA, "knap6.mps")),
    "problem_1": SIMPLEX_SMALL["problem_1"][0],
    **{f"fuzz{seed}": (lambda p, seed=seed:
                       p.random_instance(np.random.default_rng(seed))[0])
       for seed in (0, 1, 2)},
}


@pytest.mark.parametrize("name", sorted(DF32_CASES))
def test_df32_solve_matches_jax(name):
    build = DF32_CASES[name]
    jax_out = jax_solve_general_form(build(JAX), JaxConfig(**DF32))
    port_out = solve_general_form(build(PORT), SolverConfig(platform="cpu", **DF32))
    assert _verdict(*port_out) == _verdict(*jax_out)


def test_df32_problem_2_matches_jax():
    jax_res = jax_solve_relaxation(JAX.problem_2(), JaxConfig(**DF32))
    port_res = solve_relaxation(PORT.problem_2(), SolverConfig(platform="cpu", **DF32))
    assert port_res.status.value == jax_res.status.value
    assert port_res.exact_objective == jax_res.exact_objective
    assert port_res.stats.certified and jax_res.stats.certified


def test_make_engine_returns_the_df32_engine():
    engine = make_engine(SolverConfig(platform="cpu", carry="df32"), torch.device("cpu"))
    assert isinstance(engine, DoubleFloatEngine) and engine.name == "df32"


def test_df32_with_a_mesh_raises_value_error():
    """Both packages refuse the df32 carry under a mesh (a single-device
    rescue path); the port's mesh is a world of one on gloo."""
    import torch.distributed as dist

    from relp_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from relp_tpu_torch.parallel import initialize_multihost, make_mesh

    with pytest.raises(ValueError):
        jax_solve_relaxation(
            JAX.problem_2(), JaxConfig(**DF32),
            mesh=jax_make_mesh((1, len(jax.devices()))),
        )
    initialize_multihost(platform="cpu")
    try:
        with pytest.raises(ValueError):
            solve_relaxation(PORT.problem_2(), SolverConfig(platform="cpu", **DF32),
                             mesh=make_mesh((1, 1)))
    finally:
        dist.destroy_process_group()
