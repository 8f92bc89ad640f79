"""Device meshes over ``torch.distributed``: the port of
``relp_tpu.parallel.mesh``.

One process per device.  :func:`initialize_multihost` starts the default
process group (NCCL for CUDA, gloo for the CPU) and binds the process to
its card; :func:`make_mesh` lays the world out as a ``DeviceMesh`` with the
JAX package's axis names, "batch" (independent LP scenarios, PDHG's rows)
and "col" (tableau columns, PDHG's columns).  The collectives that GSPMD
inserts in the JAX package are written out in
``relp_tpu_torch.parallel.sharded`` and ``relp_tpu_torch.firstorder.pdhg``.

Launch several processes with ``torchrun --nproc-per-node K script.py``
(each calls ``initialize_multihost()`` with no arguments), or pass the
coordinator's address, the world size and the rank explicitly.  A process
started any other way is a world of one.  :func:`shutdown_multihost` ends
it.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    platform: Optional[str] = None,
) -> None:
    """Start the default process group; call once per process before
    :func:`make_mesh`.

    ``platform`` names the device as ``SolverConfig.platform`` does: None
    means CUDA (NCCL; the process is bound to ``cuda:LOCAL_RANK``, raising
    without a card), ``"cpu"`` gloo.  With no coordinator the address, world
    size and rank come from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), the analog of
    JAX's auto-detection; without those the process is a world of one on a
    free port of this host.  ``coordinator_address`` is ``"host:port"``.
    """
    from relp_tpu_torch.config import SolverConfig, torch_device

    device = torch_device(SolverConfig(platform=platform))
    if dist.is_initialized():
        raise RuntimeError("initialize_multihost: the process group is already up")
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "WORLD_SIZE" in env and "RANK" in env:
            init_method = "env://"
            world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        else:
            init_method = f"tcp://localhost:{_free_port()}"
            world, rank = 1, 0
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "initialize_multihost: a coordinator needs num_processes "
                "and process_id"
            )
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank
    )


def shutdown_multihost() -> None:
    """End what :func:`initialize_multihost` started: drop the captured
    steps of every mesh's column group (``simplex.graphs.release_group``;
    their graphs hold the group's collectives), then destroy every process
    group.  The counterpart of ``jax.distributed.shutdown``."""
    from relp_tpu_torch.simplex import graphs

    graphs.release_group()
    dist.destroy_process_group()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("batch", "col"),
):
    """A ``DeviceMesh`` over the world, one rank per device.

    ``shape=None`` puts every rank on the last ("col") axis: column-sharded
    pricing; the "batch" axis shards independent LP scenarios.  Raises
    ``ValueError`` when the shape does not hold the world.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call initialize_multihost first")
    n = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {tuple(axis_names)}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not match {n} devices")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=tuple(axis_names))


def default_mesh():
    return make_mesh()
