"""Capability probe 2: a bulk copy into shared memory at a run-time offset,
and a load from a run-time start.

The port of exp/probe_mosaic2.py (its ``__main__``). Each check runs one
kernel of kernels/mosaic2.py on the JAX program's own input and holds it to
the JAX program's expected value, with ``report``'s line on stderr and one
JSON line on stdout (probes/probe_mosaic.py's ``report``; a wrong value or
an exception raises after its FAIL line):

  hbm_to_smem_dma      the window of 3 * arange(8192) at 2048, word 17:
                       2065 * 3 = 6195
  dyn_start_vmem_load  arange(4096)[37 : 1061], starting 37, 38, 39, 40

The inputs are the JAX program's fixed ones; there is nothing to size.

Usage: python -m tpujoin_torch.probes.probe_mosaic2 [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from tpujoin_torch.kernels import mosaic2
from tpujoin_torch.probes.bench_mat2 import ep
from tpujoin_torch.probes.probe_mosaic import IMAX, IMIN, report

# as probe_mosaic.EDGES: offsets at both ends of the copy's precondition,
# unaligned, past x's ends and at the i32 ends
EDGES = {"hbm_to_smem": [[0, 0], [0, 2047], [6144, 0], [6144, 2047],
                         [2048, 17], [3, 5], [-4, 5], [-2048, 2047],
                         [8190, 1], [8191, 1], [6148, 2047], [0, 2048],
                         [0, -1], [IMIN, 0], [IMIN, IMAX], [IMAX, 0],
                         [IMAX, IMAX]],
         "dyn_vec_load": [[0], [1], [37], [3072], [-1], [3073], [4096],
                          [IMIN], [IMAX]]}


def inputs(dev) -> dict:
    """Each kernel's input in the JAX program, on ``dev``."""
    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    return {"hbm_to_smem": (torch.arange(mosaic2.HS_N, dtype=torch.int32,
                                         device=dev) * 3, i32([2048, 17])),
            "dyn_vec_load": (torch.arange(mosaic2.DV_N, dtype=torch.int32,
                                          device=dev).view(1, -1), i32([37]))}


def checks(dev) -> dict:
    """The two checks of the JAX program, by its names."""
    args = inputs(dev)

    def t_hbm_to_smem():
        out = mosaic2.hbm_to_smem(*args["hbm_to_smem"])
        want = 2065 * 3
        return bool((out == want).all()), (f"val={int(out[0, 0])} "
                                           f"(want {want})")

    def t_dyn_vec_load():
        out = mosaic2.dyn_vec_load(*args["dyn_vec_load"]).cpu()
        ok = bool((out[0] == torch.arange(37, 37 + mosaic2.DV_OUT)).all())
        return ok, f"correct={ok} head={out[0, :4].tolist()}"

    return {"hbm_to_smem_dma": t_hbm_to_smem,
            "dyn_start_vmem_load": t_dyn_vec_load}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.probe_mosaic2: no CUDA device")
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
