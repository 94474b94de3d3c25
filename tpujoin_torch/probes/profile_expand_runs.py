"""Ablation profile of K7 expand_runs on synthetic gapless runs.

The port of exp/profile_expand_runs.py (its ``main()``, :133): 1M runs of
100 slots each (100M slots), each run's build start shared by 8
consecutive runs, the source an ``arange``. Each variant of the run_variant
kernel (kernels/runs_phases.py) is timed:

  full      the kernel's phases: rank search, run walk, metadata reads,
            the gather from the source slab
  noroll    the gather replaced by ``src[sb + u] + delta``
  noscalar  no run walk and no metadata reads
  norank    no rank search
  empty     the rank search and the stores only

The port adds a check the JAX program lacks: ``full`` must give every slot
t its pair (lo[t // 100] + t % 100, t // 100) wherever that build position
lies in the step's source slab (all but a few hundred slots near the
end, whose runs' build starts wrap to 0), else it raises. The human
lines go to stderr and one JSON line per measurement to stdout. Each time
is the minimum of 3 synchronized runs after a warm-up.

Usage: python -m tpujoin_torch.probes.profile_expand_runs [--runs K]
           [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpujoin_torch.kernels.runs_phases import (META, SRC, STEP, VARIANTS,
                                               check_bases, run_variant)
from tpujoin_torch.probes.bench_mat2 import emit, ep
from tpujoin_torch.utils.shapes import round_up
from tpujoin_torch.utils.timing import sync, time_fn

RUNS = 1_000_000
DUP = 100
ALIGN = 1024
CHECK_CHUNK = 1 << 26


def inputs(k: int, device: torch.device, dup: int = DUP):
    """The JAX program's synthetic runs on ``device``: (off, lo, sid, src,
    meta_base, src_base) padded as there, then nonzero (= k) and the
    capacity (= k * dup slots, all of them pairs)."""
    capacity = k * dup
    num_steps = round_up(capacity, STEP) // STEP
    k_pad = max(round_up(k, ALIGN), META)
    n = k * dup // 8                 # src reused by 8 consecutive runs
    n_pad = max(round_up(n, ALIGN), SRC)
    offs = (np.arange(k, dtype=np.int64) * dup).astype(np.int32)
    lo = ((np.arange(k, dtype=np.int64) // 8) * dup
          % max(n - dup, 1)).astype(np.int32)
    offp = np.full(k_pad, 0x7FFFFFFF, np.int32)
    offp[:k] = offs
    lop = np.zeros(k_pad, np.int32)
    lop[:k] = lo
    sidp = np.zeros(k_pad, np.int32)
    sidp[:k] = np.arange(k, dtype=np.int32)
    srcp = np.arange(n_pad, dtype=np.int32)

    t0s = np.arange(num_steps, dtype=np.int64) * STEP
    r0s = np.clip(np.searchsorted(offs, t0s, "right") - 1, 0, k - 1)
    r1s = np.clip(np.searchsorted(offs, t0s + STEP, "left") - 1, 0, k - 1)
    meta_base = np.clip((r0s // ALIGN) * ALIGN, 0, k_pad - META)
    smin = np.minimum(lo[r0s], lo[np.minimum(r0s + 1, k - 1)])
    src_base = np.clip((smin // ALIGN) * ALIGN, 0, n_pad - SRC)
    smax = lo[r1s] + dup
    if not (smax - src_base < SRC).all():
        raise ValueError("synthetic workload must fit one source slab a step")
    cols = [torch.from_numpy(x.astype(np.int32)).to(device)
            for x in (offp, lop, sidp, srcp, meta_base, src_base)]
    return (*cols, k, capacity)


def check_full(r, s, lo, src_base, dup: int, capacity: int):
    """Whether every slot t < capacity holds the probe id t // dup and,
    where lo[t // dup] + t % dup lies in its step's source slab, that
    build position (the source is an ``arange``); CHECK_CHUNK slots at a
    time. Returns (ok, slots whose position lies outside the slab): the
    JAX program's fit test looks at a step's first and last runs only,
    and runs whose build start wraps to 0 near the end miss the slab."""
    outside = 0
    for a in range(0, capacity, CHECK_CHUNK):
        t = torch.arange(a, min(a + CHECK_CHUNK, capacity), device=r.device)
        run = t // dup
        want = lo[run].long() + t % dup
        rel = want - src_base[t // STEP].long()
        inside = (rel >= 0) & (rel < SRC)
        got = r[a:a + t.shape[0]].long()
        if not (torch.equal(got[inside], want[inside])
                and torch.equal(s[a:a + t.shape[0]].long(), run)):
            return False, outside
        outside += int((~inside).sum())
    return True, outside


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=RUNS,
                    help="runs of 100 slots each")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.profile_expand_runs: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    *cols, nonzero, capacity = inputs(args.runs, dev)
    check_bases(cols[0], cols[3], cols[4], cols[5], nonzero, capacity)
    sync(dev)
    for variant in VARIANTS:
        st = time_fn(run_variant, *cols, nonzero, capacity, capacity,
                     variant, device=dev, name=variant, rows=capacity)
        ep(f"{variant:10s} {st.seconds:.3f}s  "
           f"{capacity / st.seconds / 1e6:.0f}M pairs/s")
        emit("run_variant", st.seconds, name, variant=variant,
             pairs=capacity, pairs_per_sec=capacity / st.seconds)
    r, s = run_variant(*cols, nonzero, capacity, capacity, "full")
    ok, outside = check_full(r, s, cols[1], cols[5], DUP, capacity)
    ep(f"full: the pairs of {capacity} slots {'PASS' if ok else 'FAIL'} "
       f"({outside} slots' build positions outside their step's slab, "
       f"their probe ids checked)")
    if not ok:
        raise AssertionError("run_variant full: a slot differs from its pair")
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
