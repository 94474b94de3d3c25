"""Per-op overhead of a compare-select-add chain against block shape.

The port of exp/probe_opcost.py (its ``main()``, :51). Over a column of
N = 2^28 int32 ones, for R in {8, 32, 64, 128} (blocks of R * 128
elements) and ops in {1, 9, 33} (shifts 37, 74, ...), it times
``select_chain`` and reports seconds, ns per block and, from the second
ops value on, the marginal ns per op per block against ops = 1, as the
JAX program does. Every output is checked against the closed form: with
c_d = 37(d + 1), element u of a block holds 1 + 37 * k(k + 1) / 2 for
k = min(ops, u // 37), else it raises. The JAX program's human lines go
to stderr and one JSON line per measurement to stdout. Each time is the
minimum of 2 synchronized runs after a warm-up, as there.

Usage: python -m tpujoin_torch.probes.probe_opcost [--n N] [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from tpujoin_torch.kernels.select_chain import LANES, select_chain
from tpujoin_torch.probes.bench_mat2 import emit, ep
from tpujoin_torch.utils.timing import time_fn

N = 1 << 28
BLOCK_ROWS = (8, 32, 64, 128)
OPS = (1, 9, 33)
SHIFT = 37


def expected_block(rows: int, ops: int, device) -> torch.Tensor:
    """One block of the chain's output on ones."""
    u = torch.arange(rows * LANES, device=device)
    k = torch.clamp(u // SHIFT, max=ops)
    return (1 + SHIFT * k * (k + 1) // 2).to(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="column length")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.n <= 0 or args.n % (max(BLOCK_ROWS) * LANES):
        ap.error(f"--n must be a positive multiple of "
                 f"{max(BLOCK_ROWS) * LANES}")
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.probe_opcost: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    n = args.n
    x = torch.ones(n, dtype=torch.int32, device=dev)
    for rows in BLOCK_ROWS:
        base = None
        blocks = n // (rows * LANES)
        for ops in OPS:
            shifts = torch.arange(1, ops + 1, dtype=torch.int32,
                                  device=dev) * SHIFT
            st = time_fn(select_chain, x, shifts, ops, rows, device=dev,
                         name=f"R{rows}o{ops}", iters=2, bytes_touched=8 * n)
            per_block = st.seconds / blocks * 1e9
            msg = (f"R={rows} ops={ops}: {st.seconds:.3f}s "
                   f"{per_block:.0f}ns/block")
            marginal = None
            if base is None:
                base = st.seconds
            else:
                marginal = (st.seconds - base) / (ops - 1) / blocks * 1e9
                msg += f" marginal={marginal:.1f}ns/op"
            ep(msg)
            emit("select_chain", st.seconds, name, rows=rows, ops=ops,
                 n=n, blocks=blocks, ns_per_block=per_block,
                 marginal_ns_per_op=marginal, gbps=st.gbps)
            got = select_chain(x, shifts, ops, rows).view(blocks, -1)
            if not torch.equal(got, expected_block(rows, ops, dev).expand(
                    blocks, -1)):
                raise AssertionError(f"select_chain R={rows} ops={ops}: not "
                                     f"the closed form")
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
