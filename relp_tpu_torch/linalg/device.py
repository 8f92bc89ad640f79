"""Device lowering helpers: padding exact host data into dense tiled arrays.

TPU-specific design (no reference counterpart): the MXU wants static shapes
padded to lane multiples (128).  Padding rows/columns are zero; the simplex
state machinery guarantees padded rows stay pinned to identity basis columns
so they never interact with the solve (see relp_tpu_torch.simplex.lowering).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Sequence, Tuple

import numpy as np


def pad_to_multiple(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def pad_vector(values: Sequence[float], target: int, dtype=np.float64) -> np.ndarray:
    out = np.zeros(target, dtype=dtype)
    out[: len(values)] = values
    return out


def pad_matrix(dense: np.ndarray, target_rows: int, target_cols: int) -> np.ndarray:
    out = np.zeros((target_rows, target_cols), dtype=dense.dtype)
    out[: dense.shape[0], : dense.shape[1]] = dense
    return out


def columns_to_dense(
    columns: Sequence[Sequence[Tuple[int, Fraction]]],
    nr_rows: int,
    dtype=np.float64,
) -> np.ndarray:
    """Materialize host sparse columns as a dense float matrix."""
    out = np.zeros((nr_rows, len(columns)), dtype=dtype)
    for j, col in enumerate(columns):
        for i, v in col:
            out[i, j] = float(v)
    return out
