"""Capability probe: five kernels that use a scalar read at run time, and
the rates of a 2^30-row cumsum and a 100M-index take.

The port of exp/probe_mosaic.py (its ``__main__``). Each check runs one
kernel of kernels/mosaic.py on the JAX program's own input and holds it to
the JAX program's expected value, with ``report``'s line on stderr
(``[OK] name: ...`` or ``[FAIL] name: ...``) and one JSON line on stdout:

  roll_dynamic                    the (1, 1024) arange rolled by -5 is
                                  5, 6, ..., 1023, 0, ..., 4 (the JAX
                                  program checks its first five)
  smem_dynamic_scalar             s[s[0]] of [3, 10, 20, 30, 40] is 30
  vmem_dynamic_scalar             x[0, 9] of 7 * arange(1024) is 63
  fori_traced_bound               sum over d < 5 of (1 + d) is 15
  smem_blockspec_scalar_indexmap  block 2 of arange(4096) starts 2048

Where the JAX program prints any value and swallows exceptions, a wrong
value or an exception here prints its FAIL line and raises. Then the two
timings, each the minimum of 3 synchronized runs after a warm-up:
``cumsum_1B``, torch.cumsum over 2^30 int32 ones with ``dtype=int32`` (the
JAX program's i32 result; without it PyTorch returns int64), and
``take_100M``, index_select of 10^8 int32 indices, drawn from a seeded
generator on the device, from a 10^7-row arange (PyTorch draws other
indices than JAX's PRNG; the rate is what is measured). Both results are
checked, and a wrong one raises.

Usage: python -m tpujoin_torch.probes.probe_mosaic [--scale F] [--device cpu]
It runs on CUDA unless given ``--device cpu``; ``--scale`` shrinks the two
timings' sizes.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from tpujoin_torch.core import datagen
from tpujoin_torch.kernels import mosaic
from tpujoin_torch.probes.bench_mat2 import ep
from tpujoin_torch.utils.timing import time_fn

IMIN, IMAX = -2**31, 2**31 - 1
# each kernel's scalars (its last argument) at the edges of its domain and
# past them, at which chip_smoke.py and the card tests hold it to its plain
# version on full-range data (fori at 2^31 - 1 runs ~2^31 dependent adds,
# seconds on the card)
EDGES = {"roll": [[0], [-1], [5], [1023], [1024], [-2000], [IMIN], [IMAX]],
         "smem_dyn": [[i, IMAX, IMIN, -1, 7]
                      for i in (0, 3, 4, -1, 5, IMIN, IMAX)],
         "vmem_dyn": [[0], [9], [1023], [-1], [1024], [IMIN], [IMAX]],
         "fori": [[0], [-1], [IMIN], [1], [5], [1023], [1024], [1 << 20],
                  [IMAX]],
         "smem_block": [[0], [2], [3], [-1], [4], [IMIN], [IMAX]]}
CUMSUM_N = 1 << 30
TAKE_N = 100_000_000
TAKE_SRC = 10_000_000


def report(name: str, check, device: str) -> None:
    """Run ``check``, which returns (ok, text) or (ok, text, numbers);
    print its OK/FAIL line on stderr and its JSON line, with the numbers,
    on stdout. A wrong value or an exception raises after its FAIL line."""
    try:
        ok, text, *numbers = check()
    except Exception as e:
        msg = str(e).replace("\n", " | ")[:500]
        ep(f"[FAIL] {name}: {type(e).__name__}: {msg}")
        raise
    ep(f"[{'OK' if ok else 'FAIL'}] {name}: {text}")
    print(json.dumps({"probe": name, "ok": ok, "result": text,
                      **(numbers[0] if numbers else {}), "device": device}),
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: {text}")


def inputs(dev) -> dict:
    """Each kernel's input in the JAX program, on ``dev``."""
    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    row = torch.arange(mosaic.ROW, dtype=torch.int32, device=dev).view(1, -1)
    return {"roll": (row, i32([5])),
            "smem_dyn": (i32([3, 10, 20, 30, 40]),),
            "vmem_dyn": (row * 7, i32([9])),
            "fori": (torch.ones(1, mosaic.LANES, dtype=torch.int32,
                                device=dev), i32([5])),
            "smem_block": (torch.arange(mosaic.META, dtype=torch.int32,
                                        device=dev), i32([2]))}


def _value(out: torch.Tensor, want: int) -> tuple:
    """(ok, text) for a broadcast row that should hold ``want``."""
    ok = bool((out == want).all())
    return ok, f"val={int(out[0, 0])} (want {want})"


def checks(dev) -> dict:
    """The five checks of the JAX program, by its names."""
    args = inputs(dev)

    def t_roll():
        out = mosaic.roll(*args["roll"]).cpu()
        ok = bool((out[0] == (torch.arange(mosaic.ROW) + 5) % mosaic.ROW
                   ).all())
        return ok, f"roll(-5) correct={ok} head={out[0, :8].tolist()}"

    return {
        "roll_dynamic": t_roll,
        "smem_dynamic_scalar": lambda: _value(
            mosaic.smem_dyn(*args["smem_dyn"]), 30),
        "vmem_dynamic_scalar": lambda: _value(
            mosaic.vmem_dyn(*args["vmem_dyn"]), 63),
        "fori_traced_bound": lambda: _value(mosaic.fori(*args["fori"]), 15),
        "smem_blockspec_scalar_indexmap": lambda: _value(
            mosaic.smem_block(*args["smem_block"]), 2048),
    }


def timings(dev, scale: float) -> dict:
    """The JAX program's two timings at ``scale`` of its sizes, each
    checked."""
    def t_cumsum():
        n = max(1, int(CUMSUM_N * scale))
        x = torch.ones(n, dtype=torch.int32, device=dev)
        st = time_fn(lambda a: torch.cumsum(a, 0, dtype=torch.int32), x,
                     device=dev, name="cumsum_1B", rows=n,
                     bytes_touched=8 * n)
        last = int(torch.cumsum(x, 0, dtype=torch.int32)[-1])
        return (last == n, f"{st.seconds:.6f}s  {st.gbps:.1f} GB/s, "
                f"last={last} (want {n})",
                {"seconds": st.seconds, "rows": n, "gbps": st.gbps})

    def t_take():
        n = max(1, int(TAKE_N * scale))
        n_src = max(1, int(TAKE_SRC * scale))
        src = torch.arange(n_src, dtype=torch.int32, device=dev)
        idx = torch.randint(0, n_src, (n,),
                            generator=datagen.generator(0, dev), device=dev,
                            dtype=torch.int32)
        st = time_fn(lambda a, i: torch.index_select(a, 0, i), src, idx,
                     device=dev, name="take_100M", rows=n)
        ok = bool(torch.equal(torch.index_select(src, 0, idx), idx))
        return (ok, f"{st.seconds:.6f}s  {st.rows_per_sec / 1e6:.1f}M "
                f"idx/s from {n_src}, correct={ok}",
                {"seconds": st.seconds, "rows": n,
                 "idx_per_sec": st.rows_per_sec})

    return {"cumsum_1B": t_cumsum, "take_100M": t_take}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="size of the cumsum and take runs, as a fraction")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if not 0 < args.scale <= 1:
        ap.error("--scale must lie in (0, 1]")
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.probe_mosaic: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ep(f"device: {name}")
    for probe, check in {**checks(dev), **timings(dev, args.scale)}.items():
        report(probe, check, name)
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
