"""Microbenchmarks of the primitives the join engine is built from: what is
fast (dense streams, sorts) and what is poison (random access) on the card.

The port of bench/primitives.py, with its sizes (N = 1e8 rows, or 1e7 with
``--small``; M = N // 10), bench names and JSON keys, one line each on
stdout. What each bench runs here:

  E0 dense_add_N             ``x + 1``
  E1 gather_{random,sorted}  ``data[idx]``
  E2 scatter_random          an out-of-place ``index_put``
  E3 sort_keys_N, _M         ``torch.sort`` (PyTorch has no keys-only sort:
                             its indices come along)
     sort_keyval_N           ``torch.sort``'s values plus its indices, the
                             sorted ids of an ``arange``, as i32
  E4 searchsorted_M_in_N     ``torch.searchsorted``: one line, where the JAX
                             program has one per ``method=``, XLA lowerings
                             with no PyTorch counterpart
  E5 cumsum_N                ``torch.cumsum`` in i32
  E6 pallas_vmem_gather_...  the smem_gather kernel (kernels/smem_gather.py)
  E7 pallas_stream_copy_N    the stream_scale kernel (kernels/stream.py)

PyTorch indexes with int64 indices, so E1 and E2 widen theirs to int64
before the timed window. Each time is the minimum of 3 synchronized runs
after a warm-up (``utils.timing.time_fn``); ``hbm_frac`` is against the
card's HBM peak (``utils.hw``) and null off the card.

Usage: python -m tpujoin_torch.probes.primitives [--small] [--rows N]
                                                  [--device cpu]
It runs on CUDA unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from tpujoin_torch.core.datagen import generator
from tpujoin_torch.kernels.smem_gather import smem_gather
from tpujoin_torch.kernels.stream import stream_scale
from tpujoin_torch.utils.hw import hbm_peak_gbps
from tpujoin_torch.utils.timing import sync, time_fn

TBL, TILE = 16384, 65536       # E6: table entries, indices
CH = 512 * 1024                # E7: the TPU kernel's block, in rows


def inputs(n: int, device: torch.device):
    """The benches' columns, seeded on ``device``: (data [n] in
    [1, 2^30), idx [n // 10] in [0, n), the sorted idx, queries [n // 10]
    in [1, 2^30))."""
    m = n // 10
    gen = generator(0, device)
    data = torch.randint(1, 1 << 30, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    idx = torch.randint(0, n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    queries = torch.randint(1, 1 << 30, (m,), generator=gen, device=device,
                            dtype=torch.int32)
    return data, idx, torch.sort(idx).values, queries


def gather_inputs(device: torch.device):
    """E6's table (``arange(TBL)``) and TILE indices into it."""
    tbl = torch.arange(TBL, dtype=torch.int32, device=device)
    vidx = torch.randint(0, TBL, (TILE,), generator=generator(1, device),
                         device=device, dtype=torch.int32)
    return tbl, vidx


def stream_rows(n: int) -> int:
    """E7's rows: n cut to whole TPU blocks, as the JAX program runs it,
    or all n where that is less than one block (the kernel takes any n)."""
    return n // CH * CH or n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="N = 1e7")
    ap.add_argument("--rows", type=int, help="N, overriding --small")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("tpujoin_torch.probes.primitives: no CUDA device",
              file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    n = args.rows or (10_000_000 if args.small else 100_000_000)
    m = n // 10
    peak = hbm_peak_gbps(dev)
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")

    def timed(fn, *fn_args):
        return time_fn(fn, *fn_args, device=dev).seconds

    def report(name, seconds, nbytes):
        gbps = nbytes / seconds / 1e9
        print(json.dumps({
            "bench": name, "seconds": seconds, "gbps": gbps,
            "hbm_frac": gbps / peak if peak else None,
            "device": device_name}), flush=True)

    data, idx, idx_sorted, queries = inputs(n, dev)
    idx64, idx_sorted64 = idx.long(), idx_sorted.long()
    sync(dev)

    # E0: dense elementwise pass (upper bound sanity)
    report("dense_add_N", timed(lambda x: x + 1, data), n * 8)

    # E1: gather, random vs sorted (local) indices
    def gather(d, i):
        return d[i]

    report("gather_random_M_from_N", timed(gather, data, idx64),
           m * 8 + n * 4)
    report("gather_sorted_M_from_N", timed(gather, data, idx_sorted64),
           m * 8 + n * 4)

    # E2: scatter M into N, out of place
    vals = torch.ones(m, dtype=torch.int32, device=dev)
    report("scatter_random_M_into_N",
           timed(lambda d, i, v: d.index_put((i,), v), data, idx64, vals),
           m * 8 + n * 4)
    del idx64, idx_sorted64

    # E3: sort throughput
    report("sort_keys_N", timed(torch.sort, data), n * 4)

    def sort_keyval(x):
        keys, perm = torch.sort(x)
        return keys, perm.to(torch.int32)

    report("sort_keyval_N", timed(sort_keyval, data), n * 8)
    report("sort_keys_M", timed(torch.sort, data[:m]), m * 4)

    # E4: searchsorted
    sorted_data = torch.sort(data).values
    report("searchsorted_M_in_N",
           timed(lambda s, q: torch.searchsorted(s, q, out_int32=True),
                 sorted_data, queries), (n + m) * 4)
    del sorted_data

    # E5: cumsum
    report("cumsum_N", timed(lambda x: torch.cumsum(x, 0, dtype=torch.int32),
                             data), n * 8)

    # E6: gather from a table held in shared memory
    tbl, vidx = gather_inputs(dev)
    seconds = timed(smem_gather, tbl, vidx)
    print(json.dumps({
        "bench": "pallas_vmem_gather_64k_from_16k", "seconds": seconds,
        "gelems_per_sec": TILE / seconds / 1e9, "device": device_name}),
        flush=True)

    # E7: streaming HBM -> HBM copy (achievable bandwidth)
    nstream = stream_rows(n)
    report("pallas_stream_copy_N", timed(stream_scale, data[:nstream]),
           nstream * 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
