"""relp_tpu_torch: the exact LP solver of ``relp_tpu`` ported to PyTorch and
CUDA (NVIDIA Hopper).

The host layers (MPS import, GeneralForm, presolve, standardization,
lowering, exact certification) are the package's own copy of the JAX
package's (``io``, ``data``, ``providers``, ``exact``, ``numbers``,
``linalg``, ``simplex.lowering``, ``simplex.result``,
``utils.{checkpoint,debug}``, imports renamed); the simplex engine runs on a
torch device, with the steepest-edge pricing scan as a hand-written CUDA
kernel (:mod:`relp_tpu_torch.ops.price_scan`).  Scenario batches
(:func:`relp_tpu_torch.parallel.solve_batch`) run many LPs in lockstep,
through the hand-written batched-pivot kernels
(:mod:`relp_tpu_torch.ops.batch_pivot`) wherever their shape gate takes
the batch.  Exact branch & bound (:mod:`relp_tpu_torch.mip`, a host copy)
runs its node waves through ``solve_batch``; restarted PDHG with crossover
(:mod:`relp_tpu_torch.firstorder`), the LU + eta-ring engine
(``basis_inverse="lu"``) and the sparse host backend
(``backend="host_sparse"``) are the other solve modes.  This package
imports neither jax nor anything of ``relp_tpu``.
"""

from relp_tpu_torch.config import SolverConfig, default_config
from relp_tpu_torch.data.solution import Solution
from relp_tpu_torch.io import import_file, load_general_form
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
