"""Scenario batches and meshes: the port of ``relp_tpu.parallel``.

* :mod:`relp_tpu_torch.parallel.batch` — batched chunk runners (explicit
  batch dimension with per-LP freezing) and the batched-pivot kernel hook.
* :mod:`relp_tpu_torch.parallel.batch_driver` — ``solve_batch``: many LPs
  in lockstep, certified per LP.
* :mod:`relp_tpu_torch.parallel.mesh` — ``initialize_multihost``,
  ``make_mesh`` and ``shutdown_multihost`` over ``torch.distributed`` (NCCL
  on CUDA, gloo on the CPU).
* :mod:`relp_tpu_torch.parallel.sharded` — column sharding of the tableau
  with the collectives written out; ``solve_relaxation``, ``solve_batch``,
  ``pdhg_solve``, ``solve_first_order`` and ``solve_mip`` take ``mesh=``.
"""

from relp_tpu_torch.parallel.batch import (
    batched_dual_run_chunk,
    batched_run_chunk,
    make_batch_state,
    megakernel_run_chunk,
)
from relp_tpu_torch.parallel.batch_driver import solve_batch
from relp_tpu_torch.parallel.mesh import (
    default_mesh,
    initialize_multihost,
    make_mesh,
    shutdown_multihost,
)
from relp_tpu_torch.parallel.sharded import (
    column_shard,
    shard_batch_problem,
    shard_batch_state,
    shard_problem,
    shard_state,
    sharded_run_chunk,
)

__all__ = [
    "batched_dual_run_chunk",
    "batched_run_chunk",
    "column_shard",
    "default_mesh",
    "initialize_multihost",
    "make_batch_state",
    "make_mesh",
    "megakernel_run_chunk",
    "shard_batch_problem",
    "shard_batch_state",
    "shard_problem",
    "shard_state",
    "sharded_run_chunk",
    "shutdown_multihost",
    "solve_batch",
]
