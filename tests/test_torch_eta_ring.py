"""The eta ring's FTRAN and BTRAN (``relp_tpu_torch.ops.eta_ring``) on the
CPU, against the JAX package's ``_apply_etas_ftran``/``_apply_etas_btran``
(``relp_tpu/simplex/lu.py:77``, ``:98``; ``lax.fori_loop``s, no Pallas).

* Rings of K = 60 slots at M = 5, 30, 128 and 257, f32 and f64, from a
  seed: etas with pivots of magnitude 1-2 and other entries of about
  1/sqrt(M), rows drawn at random (or repeated), filled with 0, 1, 23
  and 60 etas, and with ``eta_count`` = K + 1 (the port's rho BTRAN of a
  masked iteration on a full ring; the JAX package's loop never sees it,
  and the kernels apply the K slots, so JAX is asked with K).
* ``eta_ftran`` (its plain version on CPU tensors: the masked loop over
  all K slots) gives the bits of the plain loop over the live slots, as
  the CPU route of ``simplex.lu`` runs it; within 1e-12 of the JAX
  package's in f64 relative to max|x'| (1e-5 in f32: XLA may contract
  x - f w into one FMA).  ``ftran_chain``, the kernel's gather, chain
  over the live rows and pass in torch, gives the plain loop's bits at
  every fill, with repeated rows, a zero pivot and a ring past the
  kernel's chain group.
* ``eta_btran`` on CPU tensors gives the matmul loop's bits; the ordered
  twin ``eta_btran_plain(..., order="kernel")`` (the kernel's summation
  order: tiles of 256 elements outside the live rows, then the live rows'
  terms in the chain, whose bits the kernel gives on a card) is within
  1e-12 (f64) and 1e-5 (f32) relative to max|y'| of the matmul loop and of
  the JAX package: only the dot's summation order differs.  Its tile sums
  add every product once.  The two-vector ``eta_btran_pair`` (plain: two
  calls) equals two single calls.
* A zero pivot w_k[r_k] gives the plain loop's inf and NaN in both passes.
* The CPU route of ``lu_ftran``/``lu_btran`` and of the pair takes the
  plain loops and never builds the CUDA library; the wrapper refuses what
  the kernels do not take before it builds anything.
* On the kernel route (``eta_ring.launches_kernel`` true on the CPU, the
  twins standing in for the kernels' launches), an LU chunk's graph key
  holds no ring fill: chunks entering with 0, 6, 12 and 18 etas replay one
  capture (the recording stand-in of tests/test_torch_graphs.py) with the
  eager chunk's bits, and LU solves reach the JAX package's exact verdicts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relp_tpu.simplex import lu as jlu
from relp_tpu_torch.ops import _build, eta_ring
from relp_tpu_torch.simplex import graphs, kernels
from relp_tpu_torch.simplex import lu
from relp_tpu_torch.testing import eta_ring_case, lu_start
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_driver import _both
from tests.test_torch_graphs import recording  # noqa: F401  (the stand-in's fixture)
from tests.test_torch_lu import LU

K = 60
SIZES = (5, 30, 128, 257)
FILLS = (0, 1, 23, K, K + 1)
DTYPES = (np.float32, np.float64)
TOL = {np.float32: 1e-5, np.float64: 1e-12}

_jax_ftran = jax.jit(jlu._apply_etas_ftran)
_jax_btran = jax.jit(jlu._apply_etas_btran)


def ring(M, dtype, fill, seed=0, repeat_rows=False):
    """``testing.eta_ring_case`` of K slots."""
    return eta_ring_case(M, K, dtype, fill, seed=seed, repeat_rows=repeat_rows)


def _torch(arrays):
    return tuple(torch.as_tensor(np.asarray(a)) for a in arrays)


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _bits(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


def ftran_chain(eta_vals, eta_rows, eta_count, x, steps=None):
    """``eta_ftran_plain`` as the kernel computes it (csrc/eta_ring.cu):
    gather the rows r_j, u_j = x[r_j] and G[k, j] = w_k[r_j]; run the chain
    over the live slots alone (f_k = u_k / G[k, k], then every later u_j <-
    u_j - f_k G[k, j], or f_k where r_j = r_k); then the pass, each element
    x_i <- x_i - f_k w_k[i], or f_k where i = r_k, in slot order.  The same
    operations in the same order at every element, so the same bits."""
    steps = eta_vals.shape[0] if steps is None else steps
    if steps == 0:
        return x
    live = torch.arange(steps) < eta_count
    rows = eta_rows[:steps].to(torch.int64)
    G = eta_vals[:steps].index_select(1, rows)
    u = x.index_select(0, rows)
    later = torch.arange(steps)
    factors = []
    for k in range(steps):
        f = u[k] / G[k, k]
        chained = torch.where(rows == rows[k], f, u - f * G[k])
        u = torch.where(live[k] & (later > k), chained, u)
        factors.append(f)
    for k in range(steps):
        new = x - factors[k] * eta_vals[k]
        new.index_copy_(0, rows[k : k + 1], factors[k].reshape(1))
        x = torch.where(live[k], new, x)
    return x


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", SIZES)
def test_ftran_matches_the_plain_loop_and_jax(M, dtype, fill):
    arrays = ring(M, dtype, fill)
    vals, rows, count, x = _torch(arrays)
    got = eta_ring.eta_ftran(vals, rows, count, x)
    live = min(fill, K)
    for steps in (live, min(K, live + 1), K):  # the CPU route's loop lengths
        assert _bits(got, eta_ring.eta_ftran_plain(vals, rows, count, x, steps))
    jax_vals, jax_rows, _count, jax_x = _jax(arrays)
    want = _jax_ftran(jax_vals, jax_rows, jnp.int32(live), jax_x)
    assert _rel(got, want) <= TOL[dtype]
    if fill == 0:
        assert _bits(got, x)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", SIZES)
def test_ftran_chain_form_gives_the_plain_loops_bits(M, dtype, fill):
    """The kernel's FTRAN in torch (gather, chain over the live rows, pass)
    against the plain loop, over the live slots and over all K."""
    vals, rows, count, x = _torch(ring(M, dtype, fill, seed=5))
    want = eta_ring.eta_ftran_plain(vals, rows, count, x)
    assert _bits(ftran_chain(vals, rows, count, x), want)
    assert _bits(ftran_chain(vals, rows, count, x, min(fill, K)), want)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", SIZES)
def test_ordered_btran_matches_the_matmul_loop_and_jax(M, dtype, fill):
    arrays = ring(M, dtype, fill, seed=1)
    vals, rows, count, y = _torch(arrays)
    got = eta_ring.eta_btran_plain(vals, rows, count, y, order="kernel")
    live = min(fill, K)
    for steps in (live, K):
        loop = eta_ring.eta_btran_plain(vals, rows, count, y, steps)
        assert _rel(got, loop) <= TOL[dtype]
        assert _bits(eta_ring.eta_btran(vals, rows, count, y, steps), loop)
    jax_vals, jax_rows, _count, jax_y = _jax(arrays)
    want = _jax_btran(jax_vals, jax_rows, jnp.int32(live), jax_y)
    assert _rel(got, want) <= TOL[dtype]
    if fill == 0:
        assert _bits(got, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", SIZES)
def test_repeated_pivot_rows(M, dtype):
    """Rows pivoted on again and again (at M = 5 every row many times):
    FTRAN the plain loop's bits, the ordered BTRAN within the tolerance of
    the matmul loop and of the JAX package."""
    arrays = ring(M, dtype, 37, seed=2, repeat_rows=True)
    vals, rows, count, x = _torch(arrays)
    assert len(set(arrays[1][:37].tolist())) <= 3
    ftran = eta_ring.eta_ftran(vals, rows, count, x)
    assert _bits(ftran, eta_ring.eta_ftran_plain(vals, rows, count, x, 37))
    assert _bits(ftran_chain(vals, rows, count, x), ftran)
    btran = eta_ring.eta_btran_plain(vals, rows, count, x, order="kernel")
    assert _rel(btran, eta_ring.eta_btran_plain(vals, rows, count, x, 37)) <= TOL[dtype]
    jax_args = _jax(arrays)
    assert _rel(ftran, _jax_ftran(*jax_args)) <= TOL[dtype]
    assert _rel(btran, _jax_btran(*jax_args)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_zero_pivot_gives_the_plain_loops_inf_and_nan(dtype):
    vals, rows, count, x = ring(30, dtype, 9, seed=3)
    vals[4, rows[4]] = 0.0
    vals, rows, count, x = _torch((vals, rows, count, x))
    ftran = eta_ring.eta_ftran(vals, rows, count, x)
    assert not torch.isfinite(ftran).all()
    assert _bits(ftran, eta_ring.eta_ftran_plain(vals, rows, count, x, 9))
    chain = ftran_chain(vals, rows, count, x)
    keep = ~torch.isnan(ftran)
    assert torch.equal(torch.isnan(chain), ~keep) and _bits(chain[keep], ftran[keep])
    btran = eta_ring.eta_btran_plain(vals, rows, count, x, order="kernel")
    loop = eta_ring.eta_btran_plain(vals, rows, count, x, 9)
    assert not torch.isfinite(btran).all()
    for test in (torch.isnan, torch.isinf, torch.isfinite):
        assert torch.equal(test(btran), test(loop))
    finite = torch.isfinite(loop)
    assert _rel(btran[finite], loop[finite]) <= TOL[dtype]


@pytest.mark.parametrize("M", [1, 31, 256, 257, 2049])
def test_tile_sums_add_every_product(M):
    """The kernel's BTRAN order (tiles, lanes, the lanes' tree, the tiles
    in order) sums each product once: exact on integers."""
    rng = np.random.default_rng(M)
    prods = torch.as_tensor(rng.integers(-8, 9, (3, M)).astype(np.float64))
    assert torch.equal(eta_ring._tile_sums(prods), prods.sum(1))


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_btran_pair_is_two_single_calls(dtype, fill):
    """Two vectors through one ring, each with its own count (rho's with
    one slot more, as the LU pivot calls it): the pair's plain version is
    two calls of the ordered twin, its CPU route two matmul loops."""
    vals, rows, count, y = _torch(ring(128, dtype, fill, seed=6))
    w = torch.as_tensor(np.random.default_rng(fill).standard_normal(128).astype(dtype))
    count_b = torch.clamp_min(count - 1, 0)
    for order in ("kernel", "matmul"):
        pair = eta_ring.eta_btran_pair_plain(vals, rows, count, y, count_b, w, order=order)
        assert _bits(pair[0], eta_ring.eta_btran_plain(vals, rows, count, y, order=order))
        assert _bits(pair[1], eta_ring.eta_btran_plain(vals, rows, count_b, w, order=order))
    got = eta_ring.eta_btran_pair(vals, rows, count, y, count_b, w, min(fill, K),
                                  min(max(fill - 1, 0), K))
    assert _bits(got[0], eta_ring.eta_btran_plain(vals, rows, count, y))
    assert _bits(got[1], eta_ring.eta_btran_plain(vals, rows, count_b, w))


@pytest.mark.parametrize("repeat_rows", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_ring_past_the_chain_group(dtype, repeat_rows):
    """K = 150 slots, past the kernels' chain group of 64 (their chain then
    reads the ring from L2): the chain form gives the plain loop's bits, the
    ordered twin stays within the tolerance of the matmul loop and of the
    JAX package."""
    K_large = 150
    assert K_large > eta_ring.CHAIN_SLOTS
    arrays = eta_ring_case(64, K_large, dtype, 140, seed=4, repeat_rows=repeat_rows)
    vals, rows, count, x = _torch(arrays)
    assert _bits(ftran_chain(vals, rows, count, x),
                 eta_ring.eta_ftran_plain(vals, rows, count, x))
    got = eta_ring.eta_btran_plain(vals, rows, count, x, order="kernel")
    assert _rel(got, eta_ring.eta_btran_plain(vals, rows, count, x)) <= TOL[dtype]
    assert _rel(got, _jax_btran(*_jax(arrays))) <= TOL[dtype]


def test_cpu_route_takes_the_plain_loops_without_the_library(monkeypatch):
    """On the CPU, lu_ftran/lu_btran run the plain loops over ``steps``
    slots (the bits they always had) and the wrappers their plain
    versions; nothing builds or loads the CUDA library or counts a
    launch."""
    def refuse():
        raise AssertionError("the CUDA library was asked for on the CPU")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(eta_ring, "_LIB", None)
    launches = dict(eta_ring.LAUNCHES)
    state, A, _c1, _c2, _mask = lu_start(m=12, n=30, pad=4, seed=5, dtype=np.float64,
                                         capacity=K)
    assert not eta_ring.launches_kernel(state.eta_vals)
    vals, rows, count, x = _torch(ring(state.xB.shape[0], np.float64, 7, seed=4))
    state = state._replace(eta_vals=vals, eta_rows=rows, eta_count=count)
    a = A[:, 3].contiguous()
    base = lu._lu_solve(state.lu, state.piv, state.B0, a, trans=0)
    assert _bits(lu.lu_ftran(state, a, 7), eta_ring.eta_ftran_plain(vals, rows, count, base, 7))
    y = eta_ring.eta_btran_plain(vals, rows, count, x, 7)
    assert _bits(lu.lu_btran(state, x, 7),
                 lu._lu_solve(state.lu, state.piv, state.B0, y, trans=1))
    assert _bits(eta_ring.eta_ftran(vals, rows, count, x, 7),
                 eta_ring.eta_ftran_plain(vals, rows, count, x, 7))
    assert _bits(eta_ring.eta_btran(vals, rows, count, x, 7), y)
    pair = eta_ring.eta_btran_pair(vals, rows, count, x, count, base, 7, 7)
    assert _bits(pair[0], y)
    assert _bits(pair[1], eta_ring.eta_btran_plain(vals, rows, count, base, 7))
    assert eta_ring._LIB is None and eta_ring.LAUNCHES == launches


@pytest.mark.parametrize("change, match", [
    (dict(x=lambda t: t.to(torch.float16)), "dtype"),
    (dict(x=lambda t: t[:5]), "shape"),
    (dict(x=lambda t: t.reshape(1, -1)), "shape"),
    (dict(eta_rows=lambda t: t.to(torch.int64)), "eta_rows"),
    (dict(eta_count=lambda t: t.reshape(1)), "eta_count"),
    (dict(eta_vals=lambda t: t.to(torch.float32)), "eta_vals"),
    (dict(eta_vals=lambda t: t.T.contiguous().T), "contiguous"),
])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(monkeypatch, change, match):
    """The launch's checks come before the library is built."""
    monkeypatch.setattr(_build, "build", lambda: pytest.fail("built the library"))
    vals, rows, count, x = _torch(ring(30, np.float64, 4))
    args = dict(eta_vals=vals, eta_rows=rows, eta_count=count, x=x)
    for name, fn in change.items():
        args[name] = fn(args[name])
    for kind in ("ftran", "btran"):
        with pytest.raises((TypeError, ValueError), match=match):
            eta_ring._launch(kind, args["eta_vals"], args["eta_rows"],
                             ((args["eta_count"], args["x"]),))
    # The pair: either vector may be the one the kernel does not take.
    with pytest.raises((TypeError, ValueError), match=match):
        eta_ring._launch("btran", args["eta_vals"], args["eta_rows"],
                         ((count, x), (args["eta_count"], args["x"])))


def test_a_launch_refuses_a_wrong_number_of_vectors(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda: pytest.fail("built the library"))
    vals, rows, count, x = _torch(ring(30, np.float64, 4))
    for kind, passes in (("ftran", ((count, x), (count, x))),
                         ("btran", ((count, x),) * 3), ("btran", ())):
        with pytest.raises(ValueError, match="vectors"):
            eta_ring._launch(kind, vals, rows, passes)


def test_another_device_or_order_raises():
    vals, rows, count, x = (t.to("meta") for t in _torch(ring(8, np.float64, 2)))
    with pytest.raises(ValueError, match="device"):
        eta_ring.eta_ftran(vals, rows, count, x)
    vals, rows, count, x = _torch(ring(8, np.float64, 2))
    with pytest.raises(ValueError, match="order"):
        eta_ring.eta_btran_plain(vals, rows, count, x, order="tree")


def _twins(kind, eta_vals, eta_rows, passes):
    """The kernels' plain versions, their bits, in place of a launch."""
    if kind == "ftran":
        return tuple(eta_ring.eta_ftran_plain(eta_vals, eta_rows, c, x) for c, x in passes)
    return tuple(eta_ring.eta_btran_plain(eta_vals, eta_rows, c, y, order="kernel")
                 for c, y in passes)


@pytest.fixture
def kernel_route(monkeypatch):
    """The CPU on the eta-ring kernels' route: every pass takes the
    launch's branch, the twins standing in for the launches."""
    monkeypatch.setattr(eta_ring, "launches_kernel", lambda x: True)
    monkeypatch.setattr(eta_ring, "_launch", _twins)


@pytest.mark.parametrize("stop_at_zero", [False, True])
@pytest.mark.parametrize("pricing", [kernels.PRICE_STEEPEST, kernels.PRICE_DANTZIG])
def test_kernel_route_lu_chunks_replay_one_capture(recording, kernel_route, pricing,
                                                    stop_at_zero):
    """Chunk after chunk from the phase-1 start, entering with 0, 6, 12
    and 18 etas in a ring of 20: one capture, its key's eta0 None, each
    replay the eager chunk's bits; the chunk reads no ring fill on the
    host (the stand-in refuses host reads)."""
    state, A, c1, _c2, mask = lu_start(m=24, n=40, pad=8, seed=3, capacity=20)
    cache, graphed, eager = graphs.ChunkGraphs(), state, state
    kw = dict(chunk=6, opt_tol=1e-9, pivot_tol=1e-9, degen_tol=1e-9, pricing=pricing,
              stop_at_zero=stop_at_zero)
    entries = []
    for _ in range(4):
        entries.append(int(eager.eta_count))
        graphed = cache.lu_run_chunk(graphed, A, A, c1, mask, **kw)
        eager = lu.lu_run_chunk(eager, A, A, c1, mask, **kw)
        for name, g, e in zip(eager._fields, graphed, eager):
            assert _bits(g, e), name
    assert len(set(entries)) > 1 and int(eager.iteration) > 6
    assert cache.captured(lu.lu_run_chunk, "eta0") == {None: 1}
    assert graphs.CAPTURES == 1 and graphs.REPLAYS == 4
    # eta0 given is not read on this route: the same key.
    cache.lu_run_chunk(state, A, A, c1, mask, eta0=5, **kw)
    assert graphs.CAPTURES == 1


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("seed", range(4))
def test_kernel_route_lu_solves_match_jax(kernel_route, seed, dtype):
    """Whole LU solves with the kernel route's passes (the ordered BTRAN
    among them): the JAX package's exact verdicts."""
    build = lambda p: p.random_instance(np.random.default_rng(seed))[0]  # noqa: E731
    jax_verdict, port_verdict = _both(build, LU, dtype)
    assert port_verdict == jax_verdict
