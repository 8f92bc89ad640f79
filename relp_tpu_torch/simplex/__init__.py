"""The simplex engine of the PyTorch port (the counterpart of
``relp_tpu.simplex``): device state, kernels, the dense engine and the
two-phase driver with exact certification."""

from relp_tpu_torch.simplex.driver import solve_general_form, solve_relaxation
from relp_tpu_torch.simplex.result import OptimizationResult, SolveStatus

__all__ = [
    "OptimizationResult",
    "SolveStatus",
    "solve_relaxation",
    "solve_general_form",
]
