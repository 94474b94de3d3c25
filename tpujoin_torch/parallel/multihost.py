"""Multi-process bring-up (the port of tpujoin/parallel/multihost.py).

One process a card: each process joins a ``torch.distributed`` process
group, and :func:`make_global_mesh` spans the world, one shard a rank, on
the rank's own card over NCCL (or on the CPU over gloo where the process
has no card). The shard programs of :mod:`tpujoin_torch.parallel` run
unchanged on it. ``torchrun --nproc-per-node=N`` sets the environment
that :func:`initialize` reads by default.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tpujoin_torch.parallel.mesh import Mesh, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group: rank ``process_id`` of ``num_processes``,
    meeting at ``coordinator_address`` ("host:port"). The arguments default
    to torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK). With a card the backend is NCCL, on the card LOCAL_RANK (set
    as the current device before the group is made); without one, gloo.
    Call once a process, before any collective."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    backend = "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
        backend = "nccl"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def make_global_mesh() -> Mesh:
    """The row mesh over every process's shard (one a rank), or, outside a
    process group, the one-shard mesh of this process."""
    return make_mesh()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def put_row_sharded(arr, mesh: Mesh) -> list[torch.Tensor]:
    """Row-shard a host-replicated array (numpy or a tensor, the same on
    every process): each process takes its own shards' row slices onto its
    own device."""
    return mesh.put_rows(arr)
