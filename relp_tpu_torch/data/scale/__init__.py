"""Prescaling framework.

Two scalers, mirroring and re-architecting reference
``presolve/scale`` (SURVEY.md comp. 9):

* :func:`scale_general_form` / :func:`scale_back_general_form` — the exact
  rational prime-factor scaler on a GeneralForm (reference: Scalable +
  Scaling, scale/mod.rs:21-96; per-prime row/column power optimization,
  scale/rational/mod.rs).  Convention identical to the reference: forward
  scaling multiplies constraint coefficients by ``row_i * col_j``, costs by
  ``cost_factor * col_j``, b (and ranges) by ``row_i``, and divides variable
  bounds by ``col_j``; a solution of the scaled problem maps back via
  ``x_j *= col_j``.
* :func:`equilibrate` — pow-2 geometric-mean equilibration of the lowered
  device arrays (TPU redesign: scaling as a float preconditioner that is
  invisible to the exact pipeline — a positive scaling never changes the
  optimal basis, and the exact certifier works on unscaled data).
"""

from relp_tpu_torch.data.scale.rational import (
    Scaling,
    scale_general_form,
    scale_back_general_form,
)
from relp_tpu_torch.data.scale.equilibrate import equilibrate

__all__ = [
    "Scaling",
    "scale_general_form",
    "scale_back_general_form",
    "equilibrate",
]
