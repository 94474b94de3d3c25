"""Flat roll of 1024-element tiles: its check, and its throughput.

The port of exp/probe_flatroll.py (its ``main()``, :74). First the check:
eight tiles of arange(1024) rolled by each k in {0, 1, 64, 127, 128, 129,
500, 1023} through ``flat_roll`` against np.roll, an OK/FAIL line each,
and a FAIL raises. Then the throughput: ``flat_roll`` over N = 2^28 int32
ones with rolls 1, 4, 10 and 20 (shifts 37, 74, ...), each output checked
to hold ``rolls`` everywhere, else it raises. The JAX program stops after
the check in interpret mode; this one runs both on the CPU as well. Its
human lines go to stderr and one JSON line per measurement to stdout.
Each time is the minimum of 2 synchronized runs after a warm-up, as
there.

Usage: python -m tpujoin_torch.probes.probe_flatroll [--n N] [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpujoin_torch.kernels.flat_roll import STEP, TILE, flat_roll
from tpujoin_torch.probes.bench_mat2 import emit, ep
from tpujoin_torch.utils.timing import time_fn

N = 1 << 28
CHECK_KS = (0, 1, 64, 127, 128, 129, 500, 1023)
ROLLS = (1, 4, 10, 20)
SHIFT = 37


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N,
                    help="column length of the throughput runs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.n <= 0 or args.n % STEP:
        ap.error(f"--n must be a positive multiple of {STEP}")
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.probe_flatroll: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    xs = torch.arange(TILE, dtype=torch.int32, device=dev).repeat(STEP // TILE)
    for k in CHECK_KS:
        out = flat_roll(xs, torch.tensor([k], dtype=torch.int32, device=dev),
                        1).view(-1, TILE).cpu().numpy()
        ref = np.roll(np.arange(TILE, dtype=np.int32), k)
        ok = bool((out == ref).all())
        ep(f"k={k}: {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flat_roll k={k}: {out[0, :8]} against "
                                 f"{ref[:8]}")
    emit("flat_roll_check", 0.0, name, ks=list(CHECK_KS), ok=True)

    n = args.n
    xb = torch.ones(n, dtype=torch.int32, device=dev)
    for rolls in ROLLS:
        shifts = torch.arange(1, rolls + 1, dtype=torch.int32,
                              device=dev) * SHIFT
        st = time_fn(flat_roll, xb, shifts, rolls, device=dev,
                     name=f"flat{rolls}", iters=2, bytes_touched=8 * n)
        ep(f"flat_roll rolls={rolls}: {st.seconds:.3f}s "
           f"({st.gbps:.0f} GB/s, {n / st.seconds / 1e6:.0f}M out/s)")
        emit("flat_roll", st.seconds, name, rows=n, rolls=rolls,
             gbps=st.gbps, out_per_sec=n / st.seconds)
        if not bool((flat_roll(xb, shifts, rolls) == rolls).all()):
            raise AssertionError(f"flat_roll rolls={rolls}: an output is not "
                                 f"{rolls} on ones")
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
