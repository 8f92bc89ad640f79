"""Pow-2 equilibration of lowered device arrays.

TPU-side prescaling (new design; the reference's factor-power framework
degenerates naturally to base-2 equilibration for floats, SURVEY.md comp. 9):
iterative geometric-mean scaling with factors rounded to powers of two, so
scaling is exact in floating point and never perturbs mantissas.

A positive scaling never changes the optimal basis, so this is invisible to
the exact certification path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _pow2_round(log2_values: np.ndarray) -> np.ndarray:
    return np.exp2(np.round(log2_values))


def equilibrate(
    A: np.ndarray,
    rounds: int = 2,
    col_limit: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Row/column pow-2 scale factors for dense A (zeros ignored).

    Returns (row_scale, col_scale) with
    ``A_scaled = diag(row_scale) A diag(col_scale)``.  ``col_limit`` stops
    column scaling after that many columns (artificial identity columns
    should keep scale 1).
    """
    m, n = A.shape
    row_scale = np.ones(m, dtype=A.dtype)
    col_scale = np.ones(n, dtype=A.dtype)
    ncols = n if col_limit is None else col_limit

    work = np.abs(A.copy())
    nz = work != 0
    with np.errstate(divide="ignore"):
        for _ in range(rounds):
            # rows: geometric mean of nonzeros -> scale to ~1
            logs = np.where(nz, np.log2(work, where=nz), 0.0)
            counts = nz.sum(axis=1)
            # out= zeros: np.divide(where=) leaves unselected lanes
            # UNINITIALIZED, and exp2 on that garbage overflows (the result
            # was masked afterwards, but the warning was real).
            mean = np.divide(
                logs.sum(axis=1),
                np.maximum(counts, 1),
                out=np.zeros(m, dtype=A.dtype),
                where=counts > 0,
            )
            r = _pow2_round(-mean)
            r = np.where(counts > 0, r, 1.0)
            work *= r[:, None]
            row_scale *= r

            logs = np.where(nz, np.log2(work, where=nz), 0.0)
            counts = nz.sum(axis=0)
            mean = np.divide(
                logs.sum(axis=0),
                np.maximum(counts, 1),
                out=np.zeros(n, dtype=A.dtype),
                where=counts > 0,
            )
            c = _pow2_round(-mean)
            c = np.where(counts > 0, c, 1.0)
            c[ncols:] = 1.0
            work *= c[None, :]
            col_scale *= c

    return row_scale, col_scale
