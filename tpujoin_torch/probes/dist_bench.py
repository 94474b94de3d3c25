"""Distributed shuffle-join scaling bench (the port of bench/dist_bench.py).

Rows/s of ``distributed_hash_join`` at each mesh size, with
``--rows-per-device`` rows a side a shard, and the real rows each shard
receives to join (max and mean, ``skew.shard_rows``). Two forms:

- started by ``torchrun --nproc-per-node=N`` (one rank a card, NCCL), the
  mesh is the world; the same rows a shard also run on one shard of the
  rank's own card, and the summary line gives the weak-scaling
  efficiency (rows/s a rank at N ranks over rows/s on one card);
- otherwise the mesh sizes 1, 2, 4, ... up to ``--shards`` run in this
  process on ``--device``. In-process shards run one after another on one
  device, so their time is no scaling figure: the summary line carries
  no efficiency and says why.

Output: one JSON line a mesh size on stderr, the summary line on stdout.
Each time is the minimum of 3 synchronized runs after a warm-up; keys are
uniform in [1, ``--key-max``] from seed 0, made on the device.

Usage: python -m tpujoin_torch.probes.dist_bench [--shards N]
           [--rows-per-device R] [--key-max K] [--skew] [--verify]
           [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist

from tpujoin_torch import oracle
from tpujoin_torch.core.datagen import generator, uniform_keys
from tpujoin_torch.parallel import multihost
from tpujoin_torch.parallel.mesh import Mesh, make_mesh
from tpujoin_torch.parallel.shuffle_join import distributed_hash_join
from tpujoin_torch.parallel.skew import shard_rows
from tpujoin_torch.utils.timing import time_fn


def measure(mesh, rows_per_device: int, key_max: int, skew: bool,
            verify: bool) -> dict:
    """One mesh size: the join's rows/s (the rows of a side over its
    seconds, as bench/dist_bench.py counts them) and the shards' received
    rows."""
    rows = rows_per_device * mesh.size
    gen = generator(0, mesh.device)
    rk = uniform_keys(gen, rows, 1, key_max)
    sk = uniform_keys(gen, rows, 1, key_max)
    expected = rows * rows // key_max + 1

    def join():
        return distributed_hash_join(rk, sk, mesh=mesh, skew=skew,
                                     expected_matches=expected)

    stat = time_fn(join, device=mesh.device, name="shuffle_join", rows=rows)
    recv = shard_rows(rk, sk, mesh=mesh, skew=skew)
    rec = {"mesh": mesh.size, "in_process": mesh.group is None,
           "rows": rows, "seconds": stat.seconds,
           "rows_per_sec": rows / stat.seconds,
           "rows_per_sec_per_device": rows / stat.seconds / mesh.size,
           "received_rows_max": int(recv.max()),
           "received_rows_mean": float(recv.mean())}
    if verify:
        r_ids, s_ids = join()
        rec["oracle"] = oracle.check_join(rk, sk, r_ids, s_ids)
        if rec["oracle"] != 1:
            raise AssertionError(f"mesh {mesh.size}: the join fails the "
                                 f"oracle")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=8,
                    help="the largest in-process mesh (no process group)")
    ap.add_argument("--rows-per-device", type=int, default=1 << 20)
    ap.add_argument("--key-max", type=int, default=1 << 20)
    ap.add_argument("--skew", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("tpujoin_torch.probes.dist_bench: no CUDA device",
              file=sys.stderr)
        return 1

    started = "WORLD_SIZE" in os.environ     # run by torchrun
    if started:
        multihost.initialize()
    try:
        if started:
            world = make_mesh(device=args.device)
            # the baseline: the same rows a shard on this rank's card alone
            results = [measure(mesh, args.rows_per_device, args.key_max,
                               args.skew, args.verify)
                       for mesh in (Mesh(1, world.device), world)]
        else:
            results = [measure(make_mesh(d, device=args.device),
                               args.rows_per_device, args.key_max,
                               args.skew, args.verify)
                       for d in (1, 2, 4, 8, 16, 32) if d <= args.shards]
        for rec in results:
            print(json.dumps(rec), file=sys.stderr, flush=True)
        summary = {"metric": "shuffle_join_weak_scaling_efficiency",
                   "unit": f"frac (1->{results[-1]['mesh']} devices)"}
        if started:
            summary["value"] = (results[-1]["rows_per_sec_per_device"]
                                / results[0]["rows_per_sec_per_device"])
        else:
            summary["value"] = None
            summary["environment"] = (
                "in-process shards run one after another on one device: "
                "their time is no scaling figure")
        if not started or dist.get_rank() == 0:
            print(json.dumps(summary), flush=True)
    finally:
        if started:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
