"""Marker scatter plus forward fill as the probe column of the pair output.

The port of exp/probe_fill.py (its ``main()``, :85). At the
ref_high_selectivity scale (10M x 10M keys in [1, 1e5], ~1e9 pairs) it
counts the join with the port's ``build`` and ``probe_count``, compacts
the count state as probe_materialize_groups does (``merge_join._compact``),
then measures:

  scatter_markers  each run's probe id at its output offset, -1 elsewhere
                   (torch ops, kernels/forward_fill.py)
  fill_forward     the forward fill (the fill_forward kernel) at STEP
                   16K, 32K and 64K, the look-back scan's tile

and checks the filled column at STEP 32K: every slot below the total must
hold the probe id of the run that covers it (the JAX program checks the
first 2^20 slots), else it raises. The JAX program's human lines go to
stderr and one JSON line per measurement to stdout. Each time is the
minimum of 3 synchronized runs after a warm-up.

Usage: python -m tpujoin_torch.probes.probe_fill [--rows R] [--key-max K]
           [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from tpujoin_torch.kernels.forward_fill import fill_forward, scatter_markers
from tpujoin_torch.ops import merge_join as mj
from tpujoin_torch.probes.bench_mat2 import emit, ep, join_state
from tpujoin_torch.utils.timing import sync, time_fn

STEPS = (16384, 32768, 65536)
CHECK_STEP = 32768
CHECK_CHUNK = 1 << 26


def compacted_runs(rows: int, key_max: int, device: torch.device):
    """The runs of a rows x rows join of keys in [1, key_max]: (offs_c,
    sid_c, total, nonzero, cap), cap the total rounded up to 2^20."""
    ht, state, total, nonzero, k_cap, cap = join_state(rows, key_max, device)
    _, _, sid_c, offs_c = mj._compact(state, k_cap, nonzero == rows)
    return offs_c, sid_c, total, nonzero, cap


def check_filled(filled, offs_c, sid_c, nonzero: int, total: int) -> bool:
    """Whether every slot below ``total`` holds its covering run's probe
    id, CHECK_CHUNK slots at a time."""
    offs = offs_c[:nonzero].long()
    for a in range(0, total, CHECK_CHUNK):
        t = torch.arange(a, min(a + CHECK_CHUNK, total), device=offs.device)
        run = torch.searchsorted(offs, t, right=True) - 1
        if not torch.equal(filled[a:a + t.shape[0]], sid_c[run]):
            return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="build and probe rows")
    ap.add_argument("--key-max", type=int, default=100_000,
                    help="key domain [1, K]")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.probe_fill: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    offs_c, sid_c, total, nonzero, cap = compacted_runs(
        args.rows, args.key_max, dev)
    ep(f"total pairs {total}  nonzero rows {nonzero}")
    sync(dev)
    st = time_fn(scatter_markers, offs_c, sid_c, nonzero, cap, device=dev,
                 name="scatter_markers", rows=nonzero)
    ep(f"scatter: {st.seconds:.4f}s")
    emit("scatter_markers", st.seconds, name, runs=nonzero, slots=cap)
    mark2d = scatter_markers(offs_c, sid_c, nonzero, cap)
    sync(dev)
    for step in STEPS:
        stf = time_fn(fill_forward, mark2d, step, device=dev,
                      name=f"fill_{step}", rows=total)
        ep(f"fill STEP={step}: {stf.seconds:.4f}s "
           f"=> {total / stf.seconds / 1e6:.0f}M slots/s "
           f"(scatter+fill {total / (stf.seconds + st.seconds) / 1e6:.0f}"
           f"M/s)")
        emit("fill_forward", stf.seconds, name, step=step, slots=cap,
             pairs=total, slots_per_sec=total / stf.seconds,
             with_scatter_per_sec=total / (stf.seconds + st.seconds))
    filled = fill_forward(mark2d, CHECK_STEP).reshape(-1)
    ok = check_filled(filled, offs_c, sid_c, nonzero, total)
    ep(f"parity on all {total} slots: {'PASS' if ok else 'FAIL'}")
    emit("fill_forward_parity", 0.0, name, step=CHECK_STEP, slots=total,
         ok=ok)
    if not ok:
        raise AssertionError("fill_forward: a slot does not hold the probe "
                             "id of its run")
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
