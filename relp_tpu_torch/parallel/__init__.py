"""Scenario batches: the port of ``relp_tpu.parallel``.

* :mod:`relp_tpu_torch.parallel.batch` — batched chunk runners (explicit
  batch dimension with per-LP freezing) and the batched-pivot kernel hook.
* :mod:`relp_tpu_torch.parallel.batch_driver` — ``solve_batch``: many LPs
  in lockstep on one device, certified per LP.

Column sharding over a mesh (``relp_tpu.parallel.{mesh,sharded}``) is not
ported yet: ROADMAP.md Queue 1, item 16.
"""

from relp_tpu_torch.parallel.batch import (
    batched_dual_run_chunk,
    batched_run_chunk,
    make_batch_state,
    megakernel_run_chunk,
)
from relp_tpu_torch.parallel.batch_driver import solve_batch

__all__ = [
    "batched_dual_run_chunk",
    "batched_run_chunk",
    "make_batch_state",
    "megakernel_run_chunk",
    "solve_batch",
]
