"""merge_count's dense-compare strategies, head to head on the card.

The port of exp/count_variants.py (its ``main()``, :167). Two workloads,
the JAX program's: ref_low (100M x 100M keys in [1, 1e9], a probe tile's
build window about one 1024-key chunk) and ref_high (10M x 10M keys in
[1, 1e5], ~100 duplicates a key). Each of the strategies fat512, fatc512,
fatc256 and fatc128 at TILE 1024 runs on the slab_count kernel
(kernels/slab_count.py); its lo and cnt on the first 100,000 probe keys
are held against the plain version (a searchsorted pair), where the JAX
program holds each against the first strategy, and a mismatch raises.

The JAX program's human lines go to stderr and one JSON line per
measurement to stdout. Each time is the minimum of 3 synchronized runs
after a warm-up (``utils.timing.time_fn``).

Usage: python -m tpujoin_torch.probes.count_variants [--scale F]
           [--device cpu]
``--scale`` multiplies both workloads' rows (not their key domains). It
runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from tpujoin_torch.core import datagen
from tpujoin_torch.kernels.slab_count import (TILE, merge_count_v,
                                              merge_count_v_plain)
from tpujoin_torch.probes.bench_mat2 import emit, ep
from tpujoin_torch.utils.timing import sync, time_fn

WORKLOADS = (("ref_low", 100_000_000, 1_000_000_000),
             ("ref_high", 10_000_000, 100_000))
STRATEGIES = ("fat512", "fatc512", "fatc256", "fatc128")
PARITY_KEYS = 100_000


def sorted_keys(n: int, key_max: int, device: torch.device):
    """Sorted build and probe keys, n each, uniform in [1, key_max], seeded
    on ``device``."""
    gen = datagen.generator(0, device)
    bk = torch.sort(datagen.make_keys(gen, n, 1, key_max)).values
    pk = torch.sort(datagen.make_keys(gen, n, 1, key_max)).values
    return bk, pk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiplies both workloads' rows")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ep("tpujoin_torch.probes.count_variants: no CUDA device")
        return 1
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for workload, rows, key_max in WORKLOADS:
        n = max(int(rows * args.scale), 1)
        bk, pk = sorted_keys(n, key_max, dev)
        k = min(PARITY_KEYS, n)
        ref = merge_count_v_plain(bk, pk[:k])
        sync(dev)
        for strategy in STRATEGIES:
            st = time_fn(merge_count_v, bk, pk, strategy, device=dev,
                         name=strategy, rows=n)
            lo, cnt = merge_count_v(bk, pk, strategy)
            total = int(cnt.sum(dtype=torch.int64))
            parity = bool(torch.equal(lo[:k], ref[0])
                          and torch.equal(cnt[:k], ref[1]))
            ep(f"{workload} {strategy:8s} tile={TILE} {st.seconds:.3f}s "
               f"({n / st.seconds / 1e6:.0f}M keys/s) total={total} "
               f"parity={'OK' if parity else 'FAIL'}")
            emit("merge_count_v", st.seconds, name, workload=workload,
                 strategy=strategy, tile=TILE, rows=n,
                 keys_per_sec=n / st.seconds, total=total, parity=parity)
            if not parity:
                raise AssertionError(f"merge_count_v {strategy} on "
                                     f"{workload}: lo/cnt differ from the "
                                     f"plain version on the first {k} keys")
            del lo, cnt
        del bk, pk
    ep("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
