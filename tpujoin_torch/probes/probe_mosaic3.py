"""Capability probe 3: the primitives of a 2-D flat-order rotate, a roll of
the rows, a 2-D copy at a run-time row and the flat rotate itself.

The port of exp/probe_mosaic3.py (its ``__main__``). Each check runs one
kernel of kernels/mosaic3.py on the JAX program's own input and holds it to
the JAX program's expected value, with ``report``'s line on stderr and one
JSON line on stdout (probes/probe_mosaic.py's ``report``; a wrong value or
an exception raises after its FAIL line):

  sublane_roll_dynamic  the (32, 128) arange rolled by -3 along the rows
                        equals np.roll(x, -3, 0)
  2d_row_dma            rows 40 .. 71 of the (256, 128) arange
  flat_rotate_2phase    out[u] = flat[(u + 517) mod 4096] for u < 1024

The inputs are the JAX program's fixed ones; there is nothing to size.

Usage: python -m tpujoin_torch.probes.probe_mosaic3 [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpujoin_torch.kernels import mosaic3
from tpujoin_torch.probes.bench_mat2 import ep
from tpujoin_torch.probes.probe_mosaic import IMAX, IMIN, report

DELTA = 517
# as probe_mosaic.EDGES: rows at both ends of the copy's precondition and
# past them, negative shifts
EDGES = {"sublane_roll": [[0], [-1], [3], [31], [32], [1023], [1024],
                         [IMIN], [IMAX]],
         "row_dma_2d": [[0], [1], [40], [224], [-1], [-31], [-32], [225],
                        [255], [256], [IMIN], [IMAX]],
         "flat_rotate": [[0], [128], [517], [1023], [1024], [4095], [4101],
                         [-1], [-128], [-129], [IMIN], [IMAX]]}


def _tile(rows: int, dev) -> torch.Tensor:
    return torch.arange(rows * mosaic3.LANES, dtype=torch.int32,
                        device=dev).view(rows, -1)


def inputs(dev) -> dict:
    """Each kernel's input in the JAX program, on ``dev``."""
    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    return {"sublane_roll": (_tile(mosaic3.SR_ROWS, dev), i32([3])),
            "row_dma_2d": (_tile(mosaic3.RD_X_ROWS, dev), i32([40])),
            "flat_rotate": (_tile(mosaic3.FR_ROWS, dev), i32([DELTA]))}


def checks(dev) -> dict:
    """The three checks of the JAX program, by its names, each against
    numpy as there."""
    args = inputs(dev)

    def check(out, want):
        ok = bool(np.array_equal(out.cpu().numpy(), want))
        return ok, f"correct={ok}"

    def t_sublane_roll():
        x, s = args["sublane_roll"]
        return check(mosaic3.sublane_roll(x, s), np.roll(x.cpu().numpy(), -3,
                                                         0))

    def t_2d_row_dma():
        x, s = args["row_dma_2d"]
        return check(mosaic3.row_dma_2d(x, s), x.cpu().numpy()[40:72])

    def t_flat_rotate():
        x, s = args["flat_rotate"]
        flat = x.cpu().numpy().reshape(-1)
        u = np.arange(mosaic3.FR_OUT_ROWS * mosaic3.LANES)
        want = flat[(u + DELTA) % flat.size].reshape(-1, mosaic3.LANES)
        return check(mosaic3.flat_rotate(x, s), want)

    return {"sublane_roll_dynamic": t_sublane_roll,
            "2d_row_dma": t_2d_row_dma,
            "flat_rotate_2phase": t_flat_rotate}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.probe_mosaic3: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ep(f"device: {name}")
    for probe, check in checks(dev).items():
        report(probe, check, name)
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
