"""relp_tpu_torch: the exact LP solver of ``relp_tpu`` ported to PyTorch and
CUDA (NVIDIA Hopper).

The host layers (MPS import, GeneralForm, presolve, standardization,
lowering, exact certification) are shared with ``relp_tpu`` through
:mod:`relp_tpu_torch._host`; the simplex engine runs on a torch device, with
the steepest-edge pricing scan as a hand-written CUDA kernel
(:mod:`relp_tpu_torch.ops.price_scan`).  Scenario batches
(:func:`relp_tpu_torch.parallel.solve_batch`) run many LPs in lockstep,
through the hand-written batched-pivot kernels
(:mod:`relp_tpu_torch.ops.batch_pivot`) wherever their shape gate takes
the batch.  This package never imports jax.
"""

from relp_tpu_torch._host import Solution, import_file, load_general_form
from relp_tpu_torch.config import SolverConfig, default_config
from relp_tpu_torch.simplex import OptimizationResult, solve_relaxation

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "default_config",
    "import_file",
    "load_general_form",
    "solve_relaxation",
    "OptimizationResult",
    "Solution",
]
