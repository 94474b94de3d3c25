"""Command-line driver (the port of tpujoin/cli.py): one subcommand a
workload, each printing its phases' times, the result count and, with
``--verify``, the oracle's flag.

    python -m tpujoin_torch.cli join_v1 --build-rows 1000000 --verify
    python -m tpujoin_torch.cli join_v2 ... [--how inner|left|semi|anti]
    python -m tpujoin_torch.cli selection --rows 1000000 --threshold 80
    python -m tpujoin_torch.cli nested_loop --build-rows 2000 --probe-rows 2000
    python -m tpujoin_torch.cli aggregate --rows 1000000
    python -m tpujoin_torch.cli distributed --devices 4 --probe-rows 100000

join_v1 runs the v1 searchsorted engine, join_v2 the v2 sort-merge
engine. ``distributed`` runs the shuffle join on a mesh of ``--devices``
shards in this process, or, started by ``torchrun --nproc-per-node=N``,
on a process group of N ranks, one a card. Every subcommand runs on the
card unless given ``--device cpu``. Keys come from a seeded
``torch.Generator`` on the device (the build side from ``--seed``, the
probe side from ``--seed + 1``), so they differ from the JAX CLI's for
the same seed.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpujoin_torch import oracle
from tpujoin_torch.core import datagen
from tpujoin_torch.utils.device import resolve_device
from tpujoin_torch.utils.shapes import round_up
from tpujoin_torch.utils.timing import sync


def _timed(label: str, device, fn):
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    print(f"[{label}] {(time.perf_counter() - t0) * 1e6:.0f} microseconds",
          flush=True)
    return out


def _gen_keys(n: int, key_min: int, key_max: int, seed: int,
              distribution: str, device) -> torch.Tensor:
    gen = datagen.generator(seed, device)
    return datagen.make_keys(gen, n, key_min, key_max, distribution)


def _gen_values(n: int, seed: int, device) -> torch.Tensor:
    """The selection's column: f32 uniform in [0, 160)."""
    return torch.rand(n, generator=datagen.generator(seed, device),
                      device=device) * 160.0


def _keys(args, distribution: str = "uniform"):
    return (_gen_keys(args.build_rows, args.key_min, args.key_max, args.seed,
                      distribution, args.device),
            _gen_keys(args.probe_rows, args.key_min, args.key_max,
                      args.seed + 1, distribution, args.device))


def _success(ok: bool) -> int:
    print(f"success: {int(ok)}", flush=True)
    return 0 if ok else 1


def cmd_join(args, variant: str) -> int:
    from tpujoin_torch.ops import hash_join as hj
    from tpujoin_torch.ops import merge_join as mj

    bk, pk = _keys(args, args.distribution)
    dev = args.device
    if args.how != "inner":
        fn = {"left": mj.left_outer_join, "semi": mj.semi_join,
              "anti": mj.anti_join}[args.how]
        out = _timed(args.how, dev, lambda: fn(bk, pk))
        rows = len(out[0]) if isinstance(out, tuple) else len(out)
        print(f"result rows: {rows}", flush=True)
        return 0

    ht = _timed("build", dev, lambda: hj.build(bk))
    if variant == "join_v2":
        state, total, nonzero = _timed("count", dev,
                                       lambda: mj.probe_count(ht, pk))
        total, nonzero = int(total), int(nonzero)
        print(f"result rows: {total}", flush=True)
        r_ids, s_ids, _, fits = _timed("probe", dev, lambda: (
            mj.probe_materialize(ht, state,
                                 *mj.capacities(total, nonzero, 1 << 20),
                                 total=total, nonzero=nonzero)))
    else:
        lo, counts = _timed("count", dev, lambda: hj.probe_count(ht, pk))
        total = int(counts.sum(dtype=torch.int64))
        print(f"result rows: {total}", flush=True)
        r_ids, s_ids, _, fits = _timed("probe", dev, lambda: (
            hj.probe_materialize(ht, lo, counts, round_up(total, 1 << 20))))
    if not bool(fits):
        raise RuntimeError("materialize capacity undersized")
    if args.verify:
        return _success(oracle.check_join(bk, pk, r_ids[:total],
                                          s_ids[:total]) == 1)
    return 0


def cmd_selection(args) -> int:
    from tpujoin_torch.ops.filter import filter_device

    vals = _gen_values(args.rows, args.seed, args.device)
    cap = max(64, 1 << (args.rows - 1).bit_length())
    ids, total = _timed("selection", args.device, lambda: filter_device(
        vals, args.threshold, capacity=cap))
    total = int(total)
    print(f"result rows: {total}", flush=True)
    if args.verify:
        kept = vals[ids[:total].long()]
        return _success(total == int((vals < args.threshold).sum())
                        and bool((kept < args.threshold).all()))
    return 0


def cmd_nested_loop(args) -> int:
    from tpujoin_torch.ops.nested_loop_join import nested_loop_join

    bk, pk = _keys(args)
    r_ids, s_ids = _timed("nested_loop", args.device,
                          lambda: nested_loop_join(bk, pk))
    print(f"result rows: {len(r_ids)}", flush=True)
    if args.verify:
        return _success(oracle.check_join(bk, pk, r_ids, s_ids,
                                          nested=True) == 1)
    return 0


def cmd_aggregate(args) -> int:
    from tpujoin_torch.ops.aggregate import group_by_count

    keys = _gen_keys(args.rows, args.key_min, args.key_max, args.seed,
                     args.distribution, args.device)
    gk, gc = _timed("aggregate", args.device, lambda: group_by_count(keys))
    print(f"groups: {len(gk)}", flush=True)
    if args.verify:
        want_k, want_c = oracle.group_by_count(keys)
        return _success(np.array_equal(gk, want_k)
                        and np.array_equal(gc, want_c))
    return 0


def cmd_distributed(args) -> int:
    import torch.distributed as dist

    from tpujoin_torch.parallel import multihost
    from tpujoin_torch.parallel.mesh import make_mesh
    from tpujoin_torch.parallel.shuffle_join import distributed_hash_join

    started = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if started:                         # run by torchrun
        multihost.initialize()
    try:
        mesh = make_mesh(args.devices, device=args.device)
        bk, pk = _keys(args, args.distribution)
        skew = args.skew or args.distribution == "zipf"
        r_ids, s_ids = _timed("shuffle_join", mesh.device, lambda: (
            distributed_hash_join(bk, pk, mesh=mesh, skew=skew)))
        print(f"result rows: {len(r_ids)}  devices: {mesh.size}",
              flush=True)
        if args.verify:
            return _success(oracle.check_join(bk, pk, r_ids, s_ids) == 1)
        return 0
    finally:
        if started:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpujoin_torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, rows=False):
        p.add_argument("--key-min", type=int, default=1)
        p.add_argument("--key-max", type=int, default=1_000_000_000)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--distribution", default="uniform",
                       choices=["uniform", "zipf"])
        p.add_argument("--verify", action="store_true")
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
        if rows:
            p.add_argument("--rows", type=int, default=1_000_000)
        else:
            p.add_argument("--build-rows", type=int, default=1_000_000)
            p.add_argument("--probe-rows", type=int, default=1_000_000)

    for name in ("join_v1", "join_v2"):
        p = sub.add_parser(name, help="chained equi-join workload")
        common(p)
        p.add_argument("--how", default="inner",
                       choices=["inner", "left", "semi", "anti"])
    common(sub.add_parser("nested_loop", help="nested-loop join workload"))
    p = sub.add_parser("selection", help="filter + stream compaction")
    common(p, rows=True)
    p.add_argument("--threshold", type=float, default=80.0)
    common(sub.add_parser("aggregate", help="group-by count"), rows=True)
    p = sub.add_parser("distributed", help="shuffle join over a row mesh")
    common(p)
    p.add_argument("--devices", type=int, default=None,
                   help="in-process shards (default 1; under torchrun the "
                        "world)")
    p.add_argument("--skew", action="store_true",
                   help="heavy-hitter splitting (auto-enabled for zipf)")

    args = ap.parse_args(argv)
    args.device = resolve_device(device=args.device)
    if args.cmd in ("join_v1", "join_v2"):
        return cmd_join(args, args.cmd)
    return {
        "selection": cmd_selection,
        "nested_loop": cmd_nested_loop,
        "aggregate": cmd_aggregate,
        "distributed": cmd_distributed,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
