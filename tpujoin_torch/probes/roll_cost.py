"""Per-op cost of a chained tile op against tile height and op kind.

The port of exp/roll_cost.py (its ``main()``, :67). For R in {16, 64,
256, 512} and each kind of kernels/op_chain.py (a lane roll and a row roll
by a run-time shift, a row roll by 3, a row rotate by one, a select and an
iota add), it times ``op_chain`` on x = arange(R * 128) as (R, 128) with
sh = 5: ``ops`` (64) chained ops, the chain run ``steps`` (512) times, and
reports ns per op = seconds / (ops * repetitions), as the JAX program
does. On the card the repetitions are ``steps``; on the CPU the plain
version runs the chain once, so there they are 1. Every output is checked
against the chain's closed form (a roll by ops * shift, or ops adds at
once), else it raises. The JAX program's human lines go to stderr and one
JSON line per measurement to stdout. Each time is the minimum of 3
synchronized runs after a warm-up.

Usage: python -m tpujoin_torch.probes.roll_cost [--rows R [R ...]]
           [--ops N] [--steps N] [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from tpujoin_torch.kernels.op_chain import KINDS, LANES, OPS, ROWS, STEPS
from tpujoin_torch.kernels.op_chain import op_chain
from tpujoin_torch.probes.bench_mat2 import emit, ep
from tpujoin_torch.utils.timing import time_fn

PROGRAM_ROWS = (16, 64, 256, 512)
SH = 5


def closed_form(x: torch.Tensor, sh: int, kind: str, ops: int):
    """op^ops(x) in one step: a roll by ops times the shift, or the adds
    of ops ops at once (in int64, wrapped to int32)."""
    row_shift = {"roll_sub": sh, "roll_static": 3, "concat_shift": 1}
    if kind == "roll_lane":
        return torch.roll(x, ops * sh % LANES, 1)
    if kind in row_shift:
        return torch.roll(x, ops * row_shift[kind] % x.shape[0], 0)
    lane = torch.arange(LANES, dtype=torch.int64, device=x.device)
    step = (lane < sh).long() if kind == "select" else lane
    wide = x.long() + ops * step
    return ((wide + 2**31) % 2**32 - 2**31).to(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=PROGRAM_ROWS,
                    choices=ROWS, help="tile heights R")
    ap.add_argument("--ops", type=int, default=OPS, help="chained ops")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="repetitions of the chain on the card")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.ops < 1 or args.steps < 1:
        ap.error("--ops and --steps must be >= 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.roll_cost: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    reps = args.steps if dev.type == "cuda" else 1
    for rows in args.rows:
        x = torch.arange(rows * LANES, dtype=torch.int32,
                         device=dev).reshape(rows, LANES)
        for kind in KINDS:
            st = time_fn(op_chain, x, SH, kind, args.ops, args.steps,
                         device=dev, name=kind)
            ns = st.seconds / args.ops / reps * 1e9
            ep(f"R={rows:4d} {kind:14s} {ns:7.1f} ns/op")
            emit("op_chain", st.seconds, name, rows=rows, kind=kind,
                 ops=args.ops, steps=args.steps, repetitions=reps,
                 ns_per_op=ns)
            got = op_chain(x, SH, kind, args.ops, args.steps)
            if not torch.equal(got, closed_form(x, SH, kind, args.ops)):
                raise AssertionError(f"op_chain {kind} at R={rows}: not the "
                                     f"closed form of {args.ops} ops")
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
