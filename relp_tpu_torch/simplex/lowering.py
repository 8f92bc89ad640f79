"""Lowering a MatrixProvider to the device tableau.

TPU-specific design: the provider's virtual standard-form LP becomes dense
tiled arrays

* ``A``: (M, N) with columns [ real provider columns | artificial identity
  columns, one per row | zero padding ].  The artificial block realizes the
  reference's ``Fully``/``Partially`` artificial Kinds
  (tableau/kind/artificial) as physical e_i columns; padding rows keep their
  artificial basic forever so they never interact with the solve.
* ``c_phase1``: 1 on artificials of real rows (the reference's zero-sized
  ``Binary`` cost type, artificial/mod.rs:28-57), 0 elsewhere.
* ``c_phase2``: real costs on real columns, 0 elsewhere.
* ``candidate_mask``: columns allowed to enter (real, non-padding).

The initial basis takes the provider's slack pivots where available
(reference: PartialInitialBasis, partially.rs:125-205) and artificials
elsewhere; both are unit columns, so the initial basis matrix is the identity
and the initial inverse is free.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional

import numpy as np

from relp_tpu_torch.linalg.device import pad_to_multiple
from relp_tpu_torch.providers.base import MatrixProvider, PartialInitialBasis


@dataclass
class DeviceProblem:
    """Host-side description + device-ready numpy arrays of one LP."""

    A: np.ndarray  # (M, N)
    b: np.ndarray  # (M,)
    c_phase1: np.ndarray  # (N,)
    c_phase2: np.ndarray  # (N,)
    candidate_mask: np.ndarray  # (N,) bool
    initial_basis: np.ndarray  # (M,) int32
    m_real: int  # real (unpadded) row count
    n_real: int  # real (provider) column count
    art_offset: int  # artificial column for row i lives at art_offset + i
    provider: MatrixProvider
    # pow-2 equilibration factors (None when prescaling is off); the float
    # solution of the scaled system maps back via x_j *= col_scale[j].
    col_scale: Optional[np.ndarray] = None
    row_scale: Optional[np.ndarray] = None

    @property
    def M(self) -> int:
        return self.A.shape[0]

    @property
    def N(self) -> int:
        return self.A.shape[1]

    def is_artificial(self, j: int) -> bool:
        return j >= self.art_offset


def lower_provider(
    provider: MatrixProvider,
    dtype=np.float64,
    pad_to: int = 128,
    equilibrate: bool = False,
    min_rows: int = 0,
    min_cols: int = 0,
) -> DeviceProblem:
    """``min_rows``/``min_cols`` force larger padded shapes — used by the
    scenario-batch driver to lower many LPs to one common shape."""
    m_real = provider.nr_rows()
    n_real = provider.nr_columns()

    M = pad_to_multiple(max(m_real, min_rows, 1), pad_to)
    art_offset = n_real
    N = pad_to_multiple(max(n_real + M, min_cols), pad_to)

    A = np.zeros((M, N), dtype=dtype)
    c2 = np.zeros(N, dtype=dtype)
    for j in range(n_real):
        for i, v in provider.column(j).iter_entries():
            A[i, j] = float(v)
        cost = provider.cost_value(j)
        if cost:
            c2[j] = float(cost)

    b = np.zeros(M, dtype=dtype)
    rhs = provider.right_hand_side()
    assert len(rhs) == m_real
    for i, v in enumerate(rhs):
        b[i] = float(v)

    row_scale = col_scale = None
    if equilibrate:
        # Pow-2 preconditioner on the real block; b >= 0 is preserved, the
        # optimal basis is unchanged, and x_j = x'_j * col_scale[j]
        # (reference analog: the prescaling framework, SURVEY.md comp. 9).
        from relp_tpu_torch.data.scale.equilibrate import equilibrate as _equilibrate

        row_scale, col_scale = _equilibrate(A[:, :n_real])
        full_row = np.ones(M, dtype=dtype)
        full_row[: len(row_scale)] = row_scale
        full_col = np.ones(N, dtype=dtype)
        full_col[:n_real] = col_scale
        A[:, :n_real] *= row_scale[:, None]
        A[:, :n_real] *= col_scale[None, :]
        b *= full_row
        c2 *= full_col
        row_scale, col_scale = full_row, full_col

    # Artificial identity block (includes padding rows; kept unscaled so the
    # initial basis matrix stays the identity).
    for i in range(M):
        A[i, art_offset + i] = 1.0

    c1 = np.zeros(N, dtype=dtype)
    c1[art_offset : art_offset + m_real] = 1.0

    candidate_mask = np.zeros(N, dtype=bool)
    candidate_mask[:n_real] = True

    # Initial basis: slack pivots where the provider offers them.
    initial_basis = np.arange(art_offset, art_offset + M, dtype=np.int32)
    if isinstance(provider, PartialInitialBasis):
        for row, col in provider.pivot_element_indices():
            initial_basis[row] = col
            c1[art_offset + row] = 0.0  # that artificial is unused

    return DeviceProblem(
        A=A,
        b=b,
        c_phase1=c1,
        c_phase2=c2,
        candidate_mask=candidate_mask,
        initial_basis=initial_basis,
        m_real=m_real,
        n_real=n_real,
        art_offset=art_offset,
        provider=provider,
        col_scale=col_scale,
        row_scale=row_scale,
    )


def lower_removing_rows(
    problem: DeviceProblem,
    rows_to_remove: List[int],
    dtype=np.float64,
    pad_to: int = 128,
) -> "DeviceProblem":
    """Rebuild the device problem minus redundant rows (rank repair;
    reference: RemoveRows + from_artificial_removing_rows)."""
    from relp_tpu_torch.providers.filter import RemoveRows

    filtered = RemoveRows(problem.provider, rows_to_remove)
    return lower_provider(
        filtered,
        dtype=dtype,
        pad_to=pad_to,
        equilibrate=problem.col_scale is not None,
    )
