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
bf16 (inputs made in f32 from the same seed and rounded to bf16 by each
package) 5e-2, as chip_smoke.py holds the kernel: S and every output are
rounded to 8 bits, and the two packages round the epilogue's steps at other
places.

The kernel's launch (``price_scan.tiling``) is checked here for what the
kernel's indexing relies on: every row and column of the tableau summed
exactly once, every column finished (reduced over the cluster and written)
exactly once, no cluster rank without rows.
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
DTYPES = {"float32": (np.float32, 1e-5), "float64": (np.float64, 1e-12),
          "bfloat16": (np.float32, 5e-2)}


def _inputs(M, N, np_dtype, seed):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((3, M)).astype(np_dtype)
    A = rng.standard_normal((M, N)).astype(np_dtype)
    c = rng.standard_normal(N).astype(np_dtype)
    g = (1.0 + np.abs(rng.standard_normal(N))).astype(np_dtype)
    gq = np_dtype(1.0 + float(np.abs(rng.standard_normal())) * 5)
    return P, A, c, g, gq


def _port(P, A, c, g, gq, dtype=None):
    """The port's scan on the numpy inputs (rounded to ``dtype`` if given),
    its outputs as numpy (in f32 for bf16)."""
    def as_t(x):
        t = torch.as_tensor(x)
        return t if dtype is None else t.to(dtype)

    d, gnew = price_scan.fused_price_scan(as_t(P), as_t(A), as_t(c), as_t(g), as_t(gq))
    if dtype is torch.bfloat16:
        assert d.dtype == gnew.dtype == torch.bfloat16
        return d.float().numpy(), gnew.float().numpy()
    return d.numpy(), gnew.numpy()


def _assert_close(ours, theirs, tol):
    for a, b in zip(ours, theirs):
        b = np.asarray(b, dtype=np.float64)
        scale = 1.0 + float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,N", SHAPES)
def test_plain_matches_jax_kernel_and_formula(M, N, dtype):
    np_dtype, atol = DTYPES[dtype]
    P, A, c, g, gq = _inputs(M, N, np_dtype, M + N)
    launches = price_scan.LAUNCHES
    bf16 = dtype == "bfloat16"
    d, gnew = _port(P, A, c, g, gq, torch.bfloat16 if bf16 else None)
    assert price_scan.LAUNCHES == launches  # CPU tensors: the plain version
    assert d.dtype == np_dtype and gnew.dtype == np_dtype

    jx = [jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
          for x in (P, A, c, g, gq)]
    _assert_close((d, gnew), _formula(*jx), atol)
    d_k, g_k = jax_fused_price_scan(*jx, interpret=True)
    _assert_close((d, gnew), (d_k, g_k), atol if bf16 else 1e-5)


@pytest.mark.parametrize("M,N", [(100, 1000), (7, 130), (1, 3)])
def test_plain_ragged_n_matches_formula(M, N):
    """The port takes any N; the TPU kernel needed N % 128 == 0."""
    P, A, c, g, gq = _inputs(M, N, np.float64, 3 * M + N)
    d, gnew = _port(P, A, c, g, gq)
    _assert_close(
        (d, gnew), _formula(*(jnp.asarray(x) for x in (P, A, c, g)), jnp.asarray(gq)),
        1e-12,
    )


def _blocks(M, N, t):
    """(rows, columns summed, columns finished) of every CTA of the launch
    ``t``, as csrc/price_scan.cu indexes them: rank r of a tile's cluster
    sums rows [r rows_per_rank, (r + 1) rows_per_rank) of the tile's
    columns, and finishes (adds the cluster's sums of, and writes) columns
    [r own, (r + 1) own) of the tile, own = tile_cols / cluster."""
    own = t.tile_cols // t.cluster
    for col0 in range(0, N, t.tile_cols):
        cols = min(t.tile_cols, N - col0)
        for rank in range(t.cluster):
            row0 = min(M, rank * t.rows_per_rank)
            yield (range(row0, min(M, row0 + t.rows_per_rank)),
                   range(col0, col0 + cols),
                   range(col0 + min(cols, rank * own), col0 + min(cols, (rank + 1) * own)))


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("M,N", [(1, 1), (8, 128), (1024, 5120), (1920, 5248),
                                 (100000, 7)])
def test_tiling_covers_every_row_and_column(M, N, itemsize):
    t = price_scan.tiling(M, N, itemsize)
    assert t.tile_cols * itemsize in (128, 256, 512) and t.cluster in (1, 2, 4, 8)
    tiles = {}  # first column -> (columns, row ranges of its ranks)
    finished = np.zeros(N, dtype=np.int64)
    for rows, cols, done in _blocks(M, N, t):
        assert len(rows) >= 1  # no rank without rows
        assert done.start >= cols.start and done.stop <= cols.stop
        tiles.setdefault(cols.start, (cols, []))[1].append(rows)
        finished[done.start:done.stop] += 1
    assert len(tiles) * t.cluster == sum(len(r) for _c, r in tiles.values())
    assert [c for c, _r in sorted(tiles.values(), key=lambda x: x[0].start)] == [
        range(s, min(N, s + t.tile_cols)) for s in range(0, N, t.tile_cols)]
    for cols, ranks in tiles.values():  # each tile's ranks partition the rows
        assert [i for r in ranks for i in r] == list(range(M))
    assert (finished == 1).all()


def test_wrapper_rejects_other_devices():
    A = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        price_scan.fused_price_scan(
            torch.zeros((3, 2), device="meta"), A, torch.zeros(3, device="meta"),
            torch.ones(3, device="meta"), 1.0,
        )
