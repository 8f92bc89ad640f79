"""The port's fused price/Goldfarb scan against the JAX package's.

On the CPU the port's wrapper takes its plain PyTorch version, which is held
against the Pallas kernel (interpret mode, as tests/test_pallas_ops.py runs
it) and against the XLA formula of that test.  The hand-written CUDA kernel
is held against the plain version on the card only: tests/test_torch_cuda.py
(marker ``cuda``, no jax import, so it also runs on the card's machine) and
``chip_smoke.py`` phase 3.

Tolerances, as a bound on |difference| / (1 + max|expected|): f32 1e-5,
and f64 against the XLA formula 1e-12 (summation order only).  The Pallas
kernel accumulates its dot in f32 even for f64 inputs (pallas_scan.py:35,
preferred_element_type=f32), so f64 against it is held to the f32 bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from relp_tpu.ops import fused_price_scan as jax_fused_price_scan
from relp_tpu_torch.ops import price_scan
from tests.test_pallas_ops import _formula
from tests.test_torch_batch import one_torch_thread  # noqa: F401  (autouse)

SHAPES = [(8, 128), (64, 256), (96, 1280)]
DTYPES = {"float32": (np.float32, 1e-5), "float64": (np.float64, 1e-12)}


def _inputs(M, N, np_dtype, seed):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((3, M)).astype(np_dtype)
    A = rng.standard_normal((M, N)).astype(np_dtype)
    c = rng.standard_normal(N).astype(np_dtype)
    g = (1.0 + np.abs(rng.standard_normal(N))).astype(np_dtype)
    gq = np_dtype(1.0 + float(np.abs(rng.standard_normal())) * 5)
    return P, A, c, g, gq


def _port(P, A, c, g, gq):
    as_t = torch.from_numpy
    d, gnew = price_scan.fused_price_scan(
        as_t(P), as_t(A), as_t(c), as_t(g), torch.tensor(gq)
    )
    return d.numpy(), gnew.numpy()


def _assert_close(ours, theirs, tol):
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        scale = 1.0 + float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,N", SHAPES)
def test_plain_matches_jax_kernel_and_formula(M, N, dtype):
    np_dtype, atol = DTYPES[dtype]
    P, A, c, g, gq = _inputs(M, N, np_dtype, M + N)
    launches = price_scan.LAUNCHES
    d, gnew = _port(P, A, c, g, gq)
    assert price_scan.LAUNCHES == launches  # CPU tensors: the plain version
    assert d.dtype == np_dtype and gnew.dtype == np_dtype

    jx = [jnp.asarray(x) for x in (P, A, c, g)]
    _assert_close((d, gnew), _formula(*jx, jnp.asarray(gq)), atol)
    d_k, g_k = jax_fused_price_scan(*jx, jnp.asarray(gq), interpret=True)
    _assert_close((d, gnew), (d_k, g_k), 1e-5)


@pytest.mark.parametrize("M,N", [(100, 1000), (7, 130), (1, 3)])
def test_plain_ragged_n_matches_formula(M, N):
    """The port takes any N; the TPU kernel needed N % 128 == 0."""
    P, A, c, g, gq = _inputs(M, N, np.float64, 3 * M + N)
    d, gnew = _port(P, A, c, g, gq)
    _assert_close(
        (d, gnew), _formula(*(jnp.asarray(x) for x in (P, A, c, g)), jnp.asarray(gq)),
        1e-12,
    )


@pytest.mark.parametrize("M,N", [(1, 1), (8, 128), (1024, 5120), (1920, 5248),
                                 (100000, 7)])
def test_row_splits_cover_every_row(M, N):
    splits, rows = price_scan._splits(M, N)
    assert splits >= 1 and rows >= 1
    assert (splits - 1) * rows < M <= splits * rows  # no empty split


def test_wrapper_rejects_other_devices():
    A = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        price_scan.fused_price_scan(
            torch.zeros((3, 2), device="meta"), A, torch.zeros(3, device="meta"),
            torch.ones(3, device="meta"), 1.0,
        )
