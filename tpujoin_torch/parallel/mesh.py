"""The row mesh of the distributed programs (the port of
tpujoin/parallel/mesh.py).

A mesh is P shards of the row axis: tables are cut into P equal row
slices, one a shard. A process holds some of the shards and runs the
shard programs over the list of them: one shard a rank under a
``torch.distributed`` process group (NCCL on the card, gloo on the CPU),
or all P in one process on one device. The collectives the programs use
take and give one tensor a held shard, so the same program body serves
both forms, as one ``shard_map`` body serves every JAX mesh.

The in-process form is the counterpart of XLA's emulated devices: P
shards on one card (or the CPU), each collective a copy on that device,
the shards' local work run one after another. It is how the programs run
on a machine with one card; it shows their results, not their scaling.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpujoin_torch.utils.device import resolve_device


class _Done:
    """The handle of an in-process collective, done when issued."""

    def __init__(self, out):
        self._out = out

    def wait(self):
        return self._out


class _Pending:
    """The handle of an asynchronous process-group collective."""

    def __init__(self, out, work):
        self._out, self._work = out, work

    def wait(self):
        self._work.wait()
        return self._out


class Mesh:
    """P row shards, the ones this process holds (``shards``, ascending)
    and their device, with the collectives of the shard programs. Each
    collective takes a list of one tensor a held shard.

    ``group`` is the process group whose ranks are the shards (one a
    rank), or None for the in-process form, which holds all P."""

    def __init__(self, size: int, device: torch.device, group=None):
        if size < 1:
            raise ValueError(f"a mesh has at least one shard, got {size}")
        self.size = size
        self.device = torch.device(device)
        self.group = group
        self.shards = ((dist.get_rank(group),) if group is not None
                       else tuple(range(size)))

    @property
    def devices(self) -> list[torch.device]:
        """The device of each held shard."""
        return [self.device] * len(self.shards)

    def __repr__(self) -> str:
        form = "process group" if self.group is not None else "in-process"
        return (f"Mesh(size={self.size}, shards={self.shards}, "
                f"device={self.device}, {form})")

    def all_to_all(self, bufs: list[torch.Tensor], async_op: bool = False):
        """Each held shard's [P, C] send buffer: row p goes to shard p.
        Returns a list of one [P, C] tensor a held shard, whose row p came
        from shard p; with ``async_op`` a handle whose ``wait()`` returns
        that list."""
        if self.group is None:
            # out[d][p] = bufs[p][d]: one copy on the device
            out = list(torch.stack(bufs, dim=1).unbind(0))
            return _Done(out) if async_op else out
        (buf,) = bufs
        buf = buf.contiguous()
        out = torch.empty_like(buf)
        work = dist.all_to_all_single(out, buf, group=self.group,
                                      async_op=async_op)
        return _Pending([out], work) if async_op else [out]

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each held shard's [n] tensor; returns, for each held shard, the
        [P * n] concatenation of every shard's, in shard order."""
        if self.group is None:
            return [torch.cat(xs)] * len(xs)
        (x,) = xs
        x = x.contiguous()
        out = x.new_empty(self.size * x.shape[0])
        dist.all_gather_into_tensor(out, x, group=self.group)
        return [out]

    def all_reduce(self, xs: list[torch.Tensor], op: str) -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") over every shard's
        tensor of one shape: one tensor, the same on every shard."""
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce: op {op!r} is not sum or max")
        if self.group is None:
            stacked = torch.stack(xs)
            return stacked.sum(0) if op == "sum" else stacked.amax(0)
        (x,) = xs
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group)
        return out

    def put_rows(self, arr) -> list[torch.Tensor]:
        """The held shards' row slices of ``arr`` (numpy or a tensor, the
        same on every process, its length a multiple of P) on the mesh's
        device."""
        n = arr.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split into {self.size} "
                             f"shards")
        per = n // self.size
        out = []
        for s in self.shards:
            part = arr[s * per:(s + 1) * per]
            if isinstance(part, np.ndarray):
                part = torch.from_numpy(np.ascontiguousarray(part))
            out.append(part.to(self.device))
        return out


def make_mesh(n_devices: int | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """The row mesh. Under an initialized ``torch.distributed`` process
    group it spans the world, one shard a rank, on the rank's current CUDA
    device with NCCL, else on the CPU (``n_devices``, if given, must be the
    world size). Otherwise it holds ``n_devices`` shards (default 1) in
    this process on ``device``: CUDA unless the caller asks for the CPU;
    without a card it raises, as every entry point does."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"a process-group mesh spans the world of "
                             f"{world} ranks, not {n_devices}")
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl" else "cpu")
        return Mesh(world, torch.device(device), dist.group.WORLD)
    return Mesh(1 if n_devices is None else n_devices,
                resolve_device(device=device))
