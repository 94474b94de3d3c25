#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpujoin_torch) on one CUDA card.

Phases, one line each (details on stderr):
  1. device   the card, and its name and power limit from nvidia-smi;
  2. build    nvcc builds every kernel of tpujoin_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card, on
              the inputs the main path gives it (the slice's keys, sorted,
              counted, compacted): bitwise equality, and the time of both
              (CUDA events, the minimum of 5 runs after a warm-up); then K1
              on a ragged width with the i32 extremes, and a small join
              checked against the native oracle;
  4. slice    ref_low_selectivity (100M x 100M at --scale 1.0) through
              tpujoin_torch.bench, every pair checked by the native oracle,
              and every kernel's launch counter above 0 for that run.
Then one JSON line of per-kernel results, the wall time, and last the line
{"ok": true, "device": {...}}. Any failure exits non-zero before it; there
is no CPU path.

Usage: python3 chip_smoke.py [--scale F]
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from tpujoin_torch import bench, merge_join, oracle
from tpujoin_torch.core.datagen import make_keys
from tpujoin_torch.kernels import (_build, compact, expand, merge_count,
                                   merge_sort)
from tpujoin_torch.utils.shapes import round_up

IMAX = 2**31 - 1


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Minimum over ``reps`` CUDA-event-timed runs of ``fn``, in ms."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired output columns; raises on a shape
    mismatch."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {tuple(g.shape)} {g.dtype} "
                                 f"vs {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def check_kernel(name: str, run, plain, results: dict) -> None:
    """Compare kernel and plain version on the same inputs (exact), time
    both and record the numbers under ``name``."""
    err = max_abs_err(run(), plain())
    torch.cuda.synchronize()
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain, max |err| "
                             f"{err}")
    ms, plain_ms = cuda_ms(run), cuda_ms(plain)
    results[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    say("kernels", f"{name}: exact; {ms:.3f} ms (plain {plain_ms:.3f} ms)")


def main_path_keys(dev, cfg):
    """The build and probe keys of ``cfg``, made as tpujoin_torch.bench
    makes them (same generator, seed and order)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    return tuple(make_keys(gen, n, cfg.key_min, cfg.key_max, cfg.distribution,
                           cfg.zipf_s)
                 for n in (cfg.build_rows, cfg.probe_rows))


def kernels_phase(dev, cfg, results: dict) -> None:
    """Each kernel against its plain version on the inputs the main path
    gives it for ``cfg``: both sorts of the keys, the count of the sorted
    probe keys in the sorted build keys, and the compaction and expansion
    of that count state; then K1 on a ragged width with the i32 extremes,
    and a small join against the oracle."""
    bk, pk = main_path_keys(dev, cfg)
    n = bk.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    tile = merge_sort.TILE
    check_kernel("block_sort", lambda: merge_sort.block_sort(bk, ids),
                 lambda: merge_sort.segment_sort_plain(bk, ids, tile),
                 results)
    # the sort's last merge pass: runs of `run` into one of up to 2 * run
    run = tile
    while 2 * run < n:
        run *= 2
    kr, ir = merge_sort.segment_sort_plain(bk, ids, run)
    check_kernel("merge_pass", lambda: merge_sort.merge_pass(kr, ir, run),
                 lambda: merge_sort.segment_sort_plain(kr, ir, 2 * run),
                 results)
    del kr, ir
    err = max_abs_err(merge_sort.sort_pairs(bk, ids),
                      merge_sort.sort_pairs_plain(bk, ids))
    if err:
        raise AssertionError(f"sort_pairs differs from torch.sort: {err}")
    say("kernels", f"sort_pairs n={n}: exact; "
        f"{cuda_ms(lambda: merge_sort.sort_pairs(bk, ids)):.3f} ms "
        f"(torch.sort + gather "
        f"{cuda_ms(lambda: merge_sort.sort_pairs_plain(bk, ids)):.3f} ms); "
        f"last merge pass run {run}")
    bsk, _ = merge_sort.sort_pairs(bk, ids)
    m = pk.shape[0]
    pids = torch.arange(m, dtype=torch.int32, device=dev)
    psk, psid = merge_sort.sort_pairs(pk, pids)
    if max_abs_err((psk, psid), merge_sort.sort_pairs_plain(pk, pids)):
        raise AssertionError("probe-side sort_pairs differs from torch.sort")
    del bk, pk, ids, pids

    check_kernel("merge_count",
                 lambda: merge_count.merge_count(bsk, psk),
                 lambda: merge_count.merge_count_plain(bsk, psk), results)
    lo, cnt = merge_count.merge_count(bsk, psk)
    del bsk, psk
    total, nonzero = int(cnt.sum(dtype=torch.int64)), int((cnt > 0).sum())
    k_cap = round_up(nonzero, max(cfg.result_pad_multiple // 8, 1024))
    capacity = round_up(total, cfg.result_pad_multiple)
    check_kernel("compact3",
                 lambda: compact.compact3(lo, cnt, psid, k_cap),
                 lambda: compact.compact3_plain(lo, cnt, psid, k_cap),
                 results)
    lo_c, cnt_c, sid_c = compact.compact3(lo, cnt, psid, k_cap)
    del lo, cnt, psid
    offs = torch.cumsum(cnt_c, 0, dtype=torch.int32) - cnt_c
    check_kernel("expand",
                 lambda: expand.expand(offs, lo_c, sid_c, capacity),
                 lambda: expand.expand_plain(offs, lo_c, sid_c, capacity),
                 results)
    say("kernels", f"main-path widths: {n} x {m} keys, nonzero={nonzero} "
        f"k_cap={k_cap} total={total} capacity={capacity}")
    del lo_c, cnt_c, sid_c, offs

    # K1 at a ragged width with the i32 extremes present
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n = (1 << 24) + 12345
    keys = torch.randint(1, 10**9 + 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    keys[::1001] = IMAX
    keys[7::1003] = IMAX - 1
    keys[11::1009] = -IMAX - 1
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    kb, ib = merge_sort.block_sort(keys, ids)
    for got, want in ((merge_sort.block_sort(keys, ids),
                       merge_sort.segment_sort_plain(keys, ids, tile)),
                      (merge_sort.merge_pass(kb, ib, tile),
                       merge_sort.segment_sort_plain(kb, ib, 2 * tile)),
                      (merge_sort.sort_pairs(keys, ids),
                       merge_sort.sort_pairs_plain(keys, ids))):
        if max_abs_err(got, want):
            raise AssertionError("K1 differs from its plain version on the "
                                 "i32 extremes")
    say("kernels", f"K1 n={n} with the i32 extremes: exact")
    del keys, ids, kb, ib

    # a small join on the card against the oracle and the CPU path
    rng = np.random.default_rng(0)
    bk = rng.integers(1, 513, 4096).astype(np.int32)
    pk = rng.integers(1, 513, 4096).astype(np.int32)
    r, s = merge_join(torch.from_numpy(bk).to(dev),
                      torch.from_numpy(pk).to(dev), probe_chunk_rows=1500,
                      result_pad_multiple=1024)
    r_cpu, s_cpu = merge_join(bk, pk, probe_chunk_rows=1500,
                              result_pad_multiple=1024)
    same = np.array_equal(np.sort(r.astype(np.int64) << 32 | s),
                          np.sort(r_cpu.astype(np.int64) << 32 | s_cpu))
    if oracle.check_join(bk, pk, r, s) != 1 or not same:
        raise AssertionError("small join on the card fails the oracle")
    say("kernels", f"small join 4096 x 4096: {len(r)} pairs, oracle PASS")


COUNTERS = (("block_sort", merge_sort, "LAUNCHES"),
            ("merge_pass", merge_sort, "MERGE_LAUNCHES"),
            ("merge_count", merge_count, "LAUNCHES"),
            ("compact3", compact, "LAUNCHES"),
            ("expand", expand, "LAUNCHES"))


def slice_phase(dev, cfg, results: dict) -> None:
    for _, mod, attr in COUNTERS:
        setattr(mod, attr, 0)
    out = bench.bench_join(cfg, verify=True, device=dev)
    launches = {name: getattr(mod, attr) for name, mod, attr in COUNTERS}
    print(json.dumps(out), flush=True)
    say("slice", f"{cfg.build_rows} x {cfg.probe_rows}: build "
        f"{out['build_seconds']:.6f} s, count {out['count_seconds']:.6f} s, "
        f"materialize {out['materialize_seconds']:.6f} s, "
        f"{out['probe_rows_per_sec']:.0f} probe rows/s, "
        f"{out['result_rows']} pairs, launches {launches}")
    if out["verified"] is not True:
        raise AssertionError("slice result fails the oracle's multiset check")
    if not out["result_rows"] > 0:
        raise AssertionError("slice produced no pairs")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name}: no launch during the slice")
        results[name]["launches"] = count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpujoin_torch smoke run")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale of the slice phase's config")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    say("device", f"{kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    say("build", f"{time.perf_counter() - t0:.3f} s")

    src = "tpujoin_torch/csrc/"
    results = {
        "block_sort": {"source": src + "merge_sort.cu",
                       "replaces": "tpujoin/kernels/merge_sort.py:389"},
        "merge_pass": {"source": src + "merge_sort.cu",
                       "replaces": "tpujoin/kernels/merge_sort.py:307"},
        "merge_count": {"source": src + "merge_count.cu",
                        "replaces": "tpujoin/kernels/merge_count.py:138"},
        "compact3": {"source": src + "compact.cu",
                     "replaces": "tpujoin/kernels/compact.py:217"},
        "expand": {"source": src + "expand.cu",
                   "replaces": "tpujoin/kernels/expand.py:111"},
    }
    cfg = bench.scaled_config("ref_low_selectivity", args.scale)
    kernels_phase(dev, cfg, results)
    torch.cuda.empty_cache()
    slice_phase(dev, cfg, results)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]} for name, r in results.items()]}),
        flush=True)
    say("wall", f"{time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
