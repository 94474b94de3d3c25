"""Primitive costs of the 1B-pair materialization designs.

The port of exp/bench_mat2.py. At the ``ref_high_selectivity`` scale
(10M x 10M keys in 1..100,000, ~1e9 pairs; N = 2^30 rows) it measures:

  runs     probe_materialize_runs (expand_runs) on that join's count state
  groups   probe_materialize_groups (expand_groups) on the same state
  scatter  10M sorted positions into a zeroed N-row column
  cumsum   torch.cumsum over N i32
  pscan    the carry_scan kernel over N i32 ones, checked (y[-1] == N,
           y[12345] == 12346); a failed check raises
  take     a gather of N random positions from a 10M-row column
  roll     the shift_loop kernel over N / 4 rows, rolls 1, 4, 10 and 20

with the JAX program's human lines on stderr and one JSON line per
measurement on stdout. The JAX program's ``src_slab`` is a TPU VMEM knob
and has no counterpart. The scatter and the take widen their positions to
int64 (PyTorch's index type) before the timed window. Each time is the
minimum of ``iters`` synchronized runs after a warm-up, as there.

Usage: python -m tpujoin_torch.probes.bench_mat2
           [runs groups scatter cumsum pscan take roll] [--n N]
           [--rows R] [--key-max K] [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from tpujoin_torch.core import datagen
from tpujoin_torch.kernels.carry_scan import carry_scan
from tpujoin_torch.kernels.shift_loop import TILE as SHIFT_TILE
from tpujoin_torch.kernels.shift_loop import shift_loop
from tpujoin_torch.ops import merge_join as mj
from tpujoin_torch.ops.hash_join import build
from tpujoin_torch.utils.shapes import round_up
from tpujoin_torch.utils.timing import sync, time_fn

MEASUREMENTS = ("runs", "groups", "scatter", "cumsum", "pscan", "take",
                "roll")
N = 1 << 30
SCATTER_ROWS = 10_000_000      # positions scattered into N rows
TAKE_SRC = 10_000_000          # rows gathered from
ROLLS = (1, 4, 10, 20)


def ep(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(bench: str, seconds: float, device: str, **extra) -> None:
    print(json.dumps({"bench": bench, "seconds": seconds, **extra,
                      "device": device}), flush=True)


def join_state(rows: int, key_max: int, device: torch.device):
    """The count state of a rows x rows join of keys in [1, key_max] from
    seed 1: (ht, state, total, nonzero, k_cap, cap)."""
    gen = datagen.generator(1, device)
    bk = datagen.make_keys(gen, rows, 1, key_max)
    pk = datagen.make_keys(gen, rows, 1, key_max)
    ht = build(bk)
    state, total, nonzero = mj.probe_count(ht, pk)
    total, nonzero = int(total), int(nonzero)
    ep(f"total={total} nonzero={nonzero} dup={total / nonzero:.1f}")
    return (ht, state, total, nonzero, round_up(nonzero, 1 << 20),
            round_up(total, 1 << 20))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="*", choices=MEASUREMENTS,
                    help="measurements to run (default: all)")
    ap.add_argument("--n", type=int, default=N, help="rows of the columns")
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="build and probe rows of runs and groups")
    ap.add_argument("--key-max", type=int, default=100_000,
                    help="key domain [1, K] of runs and groups")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.bench_mat2: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    which = set(args.which) or set(MEASUREMENTS)
    n = args.n

    for path, materialize in (("runs", mj.probe_materialize_runs),
                              ("groups", mj.probe_materialize_groups)):
        if path not in which:
            continue
        ht, state, total, nonzero, k_cap, cap = join_state(
            args.rows, args.key_max, dev)

        def run(fn=materialize):
            return fn(ht, state, k_cap, cap, total=total, nonzero=nonzero)

        fits = bool(run()[3])
        ep(f"{path} fits={fits}")
        if not fits:
            continue
        st = time_fn(run, device=dev, name=path, rows=total, iters=1)
        ep(f"expand_{path}: {st.seconds:.3f}s "
           f"{total / st.seconds / 1e6:.0f}M pairs/s")
        emit(path, st.seconds, name, pairs=total,
             pairs_per_sec=total / st.seconds, fits=fits)
        del ht, state

    if "scatter" in which:
        count = SCATTER_ROWS * n // N
        idx = torch.randint(0, n, (count,),
                            generator=datagen.generator(2, dev), device=dev,
                            dtype=torch.int32)
        idx = torch.sort(idx).values.long()
        vals = torch.ones(count, dtype=torch.int32, device=dev)
        sync(dev)

        def scat(i, v):
            return torch.zeros(n, dtype=torch.int32, device=dev).index_put_(
                (i,), v)

        st = time_fn(scat, idx, vals, device=dev, name="scatter", iters=2,
                     bytes_touched=4 * n)
        ep(f"scatter {count} into {n} (+zeros init): {st.seconds:.3f}s "
           f"({st.gbps:.0f} GB/s)")
        emit("scatter", st.seconds, name, rows=count, gbps=st.gbps)
        del idx, vals

    for bench, fn, what in (
            ("cumsum", lambda x: torch.cumsum(x, 0, dtype=torch.int32),
             "torch.cumsum"),
            ("pscan", carry_scan, "carry_scan")):
        if bench not in which:
            continue
        x = torch.ones(n, dtype=torch.int32, device=dev)
        if bench == "pscan":
            y = fn(x)
            k = min(12345, n - 1)
            ok = int(y[-1]) == n and int(y[k]) == k + 1
            ep(f"carry_scan correct={ok}")
            if not ok:
                raise AssertionError(f"carry_scan: y[-1] = {int(y[-1])}, "
                                     f"y[{k}] = {int(y[k])} over {n} ones")
            del y
        sync(dev)
        st = time_fn(fn, x, device=dev, name=bench, iters=2,
                     bytes_touched=8 * n)
        ep(f"{what} {n} i32: {st.seconds:.3f}s ({st.gbps:.0f} GB/s)")
        emit(bench, st.seconds, name, rows=n, gbps=st.gbps)
        del x

    if "take" in which:
        src = torch.arange(TAKE_SRC, dtype=torch.int32, device=dev)
        bpos = torch.randint(0, TAKE_SRC, (n,),
                             generator=datagen.generator(3, dev), device=dev,
                             dtype=torch.int64)
        sync(dev)
        st = time_fn(lambda s, b: s[b], src, bpos, device=dev, name="take",
                     iters=1, bytes_touched=8 * n)
        ep(f"take {n} from {TAKE_SRC}: {st.seconds:.3f}s "
           f"({n / st.seconds / 1e6:.0f}M idx/s)")
        emit("take", st.seconds, name, rows=n, idx_per_sec=n / st.seconds)
        del src, bpos

    if "roll" in which:
        nr = n // 4 // SHIFT_TILE * SHIFT_TILE
        x = torch.ones(nr, dtype=torch.int32, device=dev)
        sync(dev)
        for rolls in ROLLS:
            st = time_fn(shift_loop, x, rolls, device=dev,
                         name=f"roll{rolls}", iters=2, bytes_touched=8 * nr)
            ep(f"shift_loop rolls={rolls} (TILE={SHIFT_TILE}): "
               f"{st.seconds:.3f}s ({st.gbps:.0f} GB/s, "
               f"{nr / st.seconds / 1e6:.0f}M out/s)")
            emit(f"roll{rolls}", st.seconds, name, rows=nr, rolls=rolls,
                 gbps=st.gbps)
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
