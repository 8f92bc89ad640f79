"""Exact rational verification substrate.

The reference computes *everything* in exact rational arithmetic (relp-num).
Here, floats find the optimal basis fast on TPU, and this package restores
exactness on the host:

* :mod:`relp_tpu_torch.exact.dixon` — exact rational linear solves via Dixon p-adic
  lifting (mod-p inverse + lifting + rational reconstruction), fast enough to
  certify bases with thousands of rows.
* :mod:`relp_tpu_torch.exact.certify` — given a candidate basis, exactly solve
  B x = b, verify x >= 0 and exact nonnegative reduced costs (the checks of
  the reference's debug_assert_in_basic_feasible_solution_state,
  tableau/mod.rs:319-357), compute the exact objective, and if the float
  basis is not exactly optimal run exact simplex cleanup pivots until it is.
* :mod:`relp_tpu_torch.exact.sensitivity` — exact post-optimality analysis against
  the certified basis: shadow prices, reduced costs, and mathematically
  sharp RHS/cost ranging intervals (beyond reference scope).
"""

from relp_tpu_torch.exact.dixon import exact_solve, ExactSingularError
from relp_tpu_torch.exact.certify import certify_and_repair, certify_basis
from relp_tpu_torch.exact.sensitivity import (
    ExactSensitivity,
    SensitivityReport,
    exact_sensitivity,
)

__all__ = [
    "exact_solve",
    "ExactSingularError",
    "certify_and_repair",
    "certify_basis",
    "ExactSensitivity",
    "SensitivityReport",
    "exact_sensitivity",
]
