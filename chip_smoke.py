#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpujoin_torch) on one CUDA card.

Phases, one line each (details on stderr):
  1. device   the card, and its name and power limit from nvidia-smi;
  2. build    nvcc builds every kernel of tpujoin_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card, on
              the inputs the main paths give it, bitwise, and the time of
              both (CUDA events, the minimum of 5 runs after a warm-up):
              K1-K4 on ref_low_selectivity's keys (sorted, counted,
              compacted), then K1 on a ragged width with the i32 extremes
              and a small join checked against the native oracle; K5 and
              K7 (expand_fill, expand_groups, expand_runs) on
              ref_high_selectivity's count state at its full capacity
              (~1e9 slots), and probe_materialize_groups on that state,
              which is expand_groups' path;
  4. runs     a 4096 x 4096 join with ~16 matches per row through
              merge_join on the card: the runs path (expand_runs), checked
              against the oracle and the CPU path;
  5. slices   ref_low_selectivity (100M x 100M at --scale 1.0) and
              ref_high_selectivity (10M x 10M, ~1e9 pairs, full size)
              through tpujoin_torch.bench, every pair checked (the native
              oracle; for the dense slice the RLE oracle and window
              checksums of every slot), and each path's kernels' launch
              counters above 0 for that run, from 0 just before it;
  6. k6       K6a compact_ids and K6b compact_cols against their plain
              versions on the filter's and the aggregate's own 100M-row
              inputs, bitwise and timed, with torch.nonzero beside K6a;
  7. ops      tpujoin_torch.bench's filter and aggregate at 100M rows,
              verified (numpy; the native group count and a numpy
              recompute of every group's sum, min and max), an 8192 x 8192
              nested-loop join on the card from numpy keys against the
              oracle and the CPU path, and filter_table, group_by_count and
              group_by_agg on the card by default against the CPU path;
              each run's kernels' launch counters above 0.
Then one JSON line of per-kernel results (times, launches, the bound from
this run's shapes, the library call's time where one computes the same
function), the wall time, and last the line
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

import tpujoin_torch
from tpujoin_torch import bench, merge_join, oracle
from tpujoin_torch.kernels import (_build, compact, expand, expand_fill,
                                   expand_groups, expand_runs, merge_count,
                                   merge_sort)
from tpujoin_torch.ops import aggregate as agg
from tpujoin_torch.ops import merge_join as mj
from tpujoin_torch.ops.hash_join import build
from tpujoin_torch.utils.shapes import round_up

IMAX = 2**31 - 1
OP_ROWS = 100_000_000        # the filter's and the aggregate's rows
CHUNK = 1 << 26              # elements per step of the kernel/plain compare
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3, NVIDIA's data sheet
# the data sheet's fp32 rate outside the tensor cores: it lists no i32
# rate, and these kernels' compares and adds are i32
OPS_PER_S = 67e12


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
    """Largest |got - want| over paired output columns, CHUNK elements at a
    time (a 1e9-slot column would need 8 GB per int64 temporary); raises on
    a shape mismatch."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {tuple(g.shape)} {g.dtype} "
                                 f"vs {tuple(w.shape)} {w.dtype}")
        g, w = g.reshape(-1), w.reshape(-1)   # a count is 0-d
        for a in range(0, g.numel(), CHUNK):
            d = g[a:a + CHUNK].long() - w[a:a + CHUNK].long()
            err = max(err, int(d.abs().max()))
    return err


def check_kernel(name: str, run, plain, results: dict | None,
                 phase: str = "kernels") -> dict:
    """Compare kernel and plain version on the same inputs (exact), time
    both and return the numbers, recorded under ``name`` unless
    ``results`` is None."""
    err = max_abs_err(run(), plain())
    torch.cuda.synchronize()
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain, max |err| "
                             f"{err}")
    got = {"max_abs_err": err, "ms": cuda_ms(run), "plain_ms": cuda_ms(plain)}
    if results is not None:
        results[name].update(got)
    say(phase, f"{name}: exact; {got['ms']:.3f} ms (plain "
        f"{got['plain_ms']:.3f} ms)")
    return got


def bound(results: dict, name: str, nbytes: float, ops: float) -> None:
    """Record the least time the card could take for ``name``'s work: the
    larger of its bytes (each input read once, each output written once)
    over the HBM rate and its operations over the op rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    results[name].update(
        bound_ms=max(by_bytes, by_ops),
        bound_by="bytes" if by_bytes >= by_ops else "operations")


def kernels_phase(dev, cfg, results: dict) -> None:
    """K1-K4 against their plain versions on the inputs the main path
    gives them for ``cfg``: both sorts of the keys, the count of the sorted
    probe keys in the sorted build keys, and the compaction and expansion
    of that count state; then K1 on a ragged width with the i32 extremes,
    and a small join against the oracle."""
    bk, pk = bench.config_keys(cfg, dev)
    n = bk.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    tile = merge_sort.TILE
    check_kernel("block_sort", lambda: merge_sort.block_sort(bk, ids),
                 lambda: merge_sort.segment_sort_plain(bk, ids, tile),
                 results)
    bound(results, "block_sort", 16 * n, n * math.log2(tile))
    # the sort's last merge pass: runs of `run` into one of up to 2 * run
    run = tile
    while 2 * run < n:
        run *= 2
    kr, ir = merge_sort.segment_sort_plain(bk, ids, run)
    check_kernel("merge_pass", lambda: merge_sort.merge_pass(kr, ir, run),
                 lambda: merge_sort.segment_sort_plain(kr, ir, 2 * run),
                 results)
    bound(results, "merge_pass", 16 * n, n)
    del kr, ir
    err = max_abs_err(merge_sort.sort_pairs(bk, ids),
                      merge_sort.sort_pairs_plain(bk, ids))
    if err:
        raise AssertionError(f"sort_pairs differs from torch.sort: {err}")
    say("kernels", f"sort_pairs n={n}: exact; "
        f"{cuda_ms(lambda: merge_sort.sort_pairs(bk, ids)):.3f} ms "
        f"(torch.sort + gather "
        f"{cuda_ms(lambda: merge_sort.sort_pairs_plain(bk, ids)):.3f} ms; "
        f"one torch.sort(stable=True), whose indices are the ids here, "
        f"{cuda_ms(lambda: torch.sort(bk, stable=True)):.3f} ms); "
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
    bound(results, "merge_count", 4 * n + 12 * m, n + m)
    lo, cnt = merge_count.merge_count(bsk, psk)
    del bsk, psk
    total, nonzero = int(cnt.sum(dtype=torch.int64)), int((cnt > 0).sum())
    k_cap = round_up(nonzero, max(cfg.result_pad_multiple // 8, 1024))
    capacity = round_up(total, cfg.result_pad_multiple)
    check_kernel("compact3",
                 lambda: compact.compact3(lo, cnt, psid, k_cap),
                 lambda: compact.compact3_plain(lo, cnt, psid, k_cap),
                 results)
    bound(results, "compact3", 12 * m + 12 * k_cap, m)
    lo_c, cnt_c, sid_c = compact.compact3(lo, cnt, psid, k_cap)
    del lo, cnt, psid
    offs = torch.cumsum(cnt_c, 0, dtype=torch.int32) - cnt_c
    check_kernel("expand",
                 lambda: expand.expand(offs, lo_c, sid_c, capacity),
                 lambda: expand.expand_plain(offs, lo_c, sid_c, capacity),
                 results)
    bound(results, "expand", 12 * k_cap + 8 * capacity, capacity)
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
    r_cpu, s_cpu = merge_join(bk, pk, device="cpu", probe_chunk_rows=1500,
                              result_pad_multiple=1024)
    if oracle.check_join(bk, pk, r, s) != 1 or not same_pairs(r, s, r_cpu,
                                                              s_cpu):
        raise AssertionError("small join on the card fails the oracle")
    say("kernels", f"small join 4096 x 4096: {len(r)} pairs, oracle PASS")


def same_pairs(r, s, r2, s2) -> bool:
    """Whether two numpy pair columns hold the same pair multiset."""
    return np.array_equal(np.sort(r.astype(np.int64) << 32 | s),
                          np.sort(r2.astype(np.int64) << 32 | s2))


def dense_kernels_phase(dev, cfg, results: dict) -> None:
    """K5 and K7 against their plain versions on the inputs the dense path
    gives them for ``cfg``: its keys sorted and counted, the RLE form and
    group heads, at the full capacity; then probe_materialize_groups on
    that state, expand_groups' path, counted and held against fill's
    columns."""
    bk, pk = bench.config_keys(cfg, dev)
    ht = build(bk)
    state, total, nonzero = mj.probe_count(ht, pk)
    total, nonzero, m = int(total), int(nonzero), pk.shape[0]
    del bk, pk
    k_cap, cap = round_up(nonzero, 1 << 20), round_up(total, 1 << 20)
    all_matched = nonzero == m
    lo_c, cnt_c, sid_c, offs_c = mj._compact(state, k_cap, all_matched)
    goff, glo, gnb, ngroups = mj._group_heads(lo_c, cnt_c, offs_c, k_cap,
                                              nonzero)
    src = ht.sorted_ids
    fill_args = (offs_c, sid_c, goff, glo, gnb, src, nonzero, ngroups,
                 total, cap)
    runs_args = (offs_c, lo_c, sid_c, src, nonzero, total, cap)
    check_kernel("expand_fill", lambda: expand_fill.expand_fill(*fill_args),
                 lambda: expand_fill.expand_fill_plain(*fill_args), results)
    check_kernel("expand_groups",
                 lambda: expand_groups.expand_groups(*fill_args),
                 lambda: expand_groups.expand_groups_plain(*fill_args),
                 results)
    check_kernel("expand_runs", lambda: expand_runs.expand_runs(*runs_args),
                 lambda: expand_runs.expand_runs_plain(*runs_args), results)
    src_read = int(gnb[:ngroups].sum())   # the build ids the groups cover
    for name in ("expand_fill", "expand_groups"):
        bound(results, name,
              8 * nonzero + 12 * ngroups + 4 * src_read + 8 * cap, cap)
    bound(results, "expand_runs", 12 * nonzero + 4 * src_read + 8 * cap, cap)
    say("kernels", f"dense widths: {ht.num_rows} x {m} keys, nonzero="
        f"{nonzero} k_cap={k_cap} groups={ngroups} total={total} "
        f"capacity={cap}, compaction "
        f"{'identity' if all_matched else 'compact3'}")
    del lo_c, cnt_c, sid_c, offs_c, goff, glo, gnb

    kw = {"total": total, "nonzero": nonzero}
    expand_groups.LAUNCHES = 0
    r, s, _, fits = mj.probe_materialize_groups(ht, state, k_cap, cap, **kw)
    launches = expand_groups.LAUNCHES
    if not bool(fits) or launches <= 0:
        raise AssertionError(f"probe_materialize_groups: fits {bool(fits)}, "
                             f"{launches} expand_groups launches")
    fill = mj.probe_materialize_fill(ht, state, k_cap, cap,
                                     all_matched=all_matched, **kw)
    if max_abs_err((r, s), fill[:2]):
        raise AssertionError("probe_materialize_groups differs from fill")
    results["expand_groups"]["launches"] = launches
    say("kernels", f"probe_materialize_groups on the dense state: {launches} "
        f"expand_groups launch(es), equal to probe_materialize_fill")


def k6_phase(dev, results: dict) -> None:
    """K6a and K6b against their plain versions on the inputs the filter
    and the aggregate give them at OP_ROWS rows: K6a on the filter's mask
    (f32 values < 80) and on the aggregate's group-start mask over sorted
    keys in [1, OP_ROWS / 10]; K6b on that mask and the value path's six
    columns. torch.nonzero is K6a's library call."""
    vals = bench.filter_values(OP_ROWS, dev)
    mask = vals < bench.FILTER_THRESHOLD
    del vals
    cap = bench.filter_capacity(OP_ROWS)
    check_kernel("compact_ids", lambda: compact.compact_ids(mask, cap),
                 lambda: compact.compact_ids_plain(mask, cap), results, "k6")
    results["compact_ids"]["library_ms"] = cuda_ms(
        lambda: torch.nonzero(mask))
    bound(results, "compact_ids", OP_ROWS + 4 * cap, OP_ROWS)
    kept = int(mask.sum())
    say("k6", f"compact_ids on the filter mask: {OP_ROWS} rows, {kept} "
        f"kept, k_cap {cap}; torch.nonzero "
        f"{results['compact_ids']['library_ms']:.3f} ms")
    del mask

    keys, values = bench.aggregate_inputs(OP_ROWS, OP_ROWS // 10, dev)
    starts, cols, _, _ = agg.value_columns(keys, values)
    del keys, values
    ngroups = int(starts.sum())
    gcap = round_up(ngroups, 1 << 20)
    boundary = check_kernel(
        "compact_ids[aggregate]", lambda: compact.compact_ids(starts, gcap),
        lambda: compact.compact_ids_plain(starts, gcap), None, "k6")
    say("k6", f"compact_ids on the group starts: {ngroups} groups, k_cap "
        f"{gcap}; bound {(OP_ROWS + 4 * gcap) / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms; torch.nonzero {cuda_ms(lambda: torch.nonzero(starts)):.3f} ms"
        f" (kernel {boundary['ms']:.3f} ms)")

    def flat(res):
        return (*res[0], res[1])

    check_kernel("compact_cols",
                 lambda: flat(compact.compact_cols(starts, cols, gcap)),
                 lambda: flat(compact.compact_cols_plain(starts, cols, gcap)),
                 results, "k6")
    ncols = len(cols)
    bound(results, "compact_cols",
          OP_ROWS + 4 * ncols * OP_ROWS + 4 * ncols * gcap, OP_ROWS)
    say("k6", f"compact_cols: {ncols} columns, {OP_ROWS} rows, {ngroups} "
        f"kept, k_cap {gcap}")


COUNTERS = {"block_sort": (merge_sort, "LAUNCHES"),
            "merge_pass": (merge_sort, "MERGE_LAUNCHES"),
            "merge_count": (merge_count, "LAUNCHES"),
            "compact3": (compact, "LAUNCHES"),
            "expand": (expand, "LAUNCHES"),
            "expand_fill": (expand_fill, "LAUNCHES"),
            "expand_groups": (expand_groups, "LAUNCHES"),
            "expand_runs": (expand_runs, "LAUNCHES"),
            "compact_ids": (compact, "IDS_LAUNCHES"),
            "compact_cols": (compact, "COLS_LAUNCHES")}


def zero_counters() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counters() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def runs_phase(dev, results: dict) -> None:
    """A join whose duplication (~16 matches per row) lands on the runs
    path, through merge_join with numpy keys (so on the card by default):
    the oracle, the CPU path and the expand_runs launches."""
    rng = np.random.default_rng(2)
    bk = rng.integers(1, 257, 4096).astype(np.int32)
    pk = rng.integers(1, 257, 4096).astype(np.int32)
    ht = build(torch.from_numpy(bk).to(dev))
    state, total, nonzero = mj.probe_count(ht, torch.from_numpy(pk).to(dev))
    total, nonzero = int(total), int(nonzero)
    name, _, _ = mj.plan_materialize(ht, state, round_up(nonzero, 1024),
                                     round_up(total, 1024), total=total,
                                     nonzero=nonzero)
    if name != "runs":
        raise AssertionError(f"the runs-path join planned {name!r}")
    zero_counters()
    r, s = merge_join(bk, pk, result_pad_multiple=1024)
    launches = read_counters()["expand_runs"]
    r_cpu, s_cpu = merge_join(bk, pk, device="cpu", result_pad_multiple=1024)
    if oracle.check_join(bk, pk, r, s) != 1 or not same_pairs(r, s, r_cpu,
                                                              s_cpu):
        raise AssertionError("runs-path join fails the oracle")
    if launches <= 0:
        raise AssertionError("runs-path join launched no expand_runs")
    results["expand_runs"]["launches"] = launches
    say("runs", f"4096 x 4096, keys 1..256: plan {name!r}, {len(r)} pairs, "
        f"oracle PASS, equal to the CPU path; {launches} expand_runs "
        f"launch(es)")


def slice_phase(dev, cfg, results: dict, path: tuple, record: tuple):
    """``cfg`` through tpujoin_torch.bench with every pair verified, the
    counters from 0 just before; every kernel of ``path`` must have
    launched, and those of ``record`` keep their counts."""
    zero_counters()
    out = bench.bench_join(cfg, verify=True, device=dev)
    launches = read_counters()
    print(json.dumps(out), flush=True)
    say("slice", f"{cfg.name} {cfg.build_rows} x {cfg.probe_rows}: "
        f"build {out['build_seconds']:.6f} s, count "
        f"{out['count_seconds']:.6f} s, materialize "
        f"{out['materialize_seconds']:.6f} s, "
        f"{out['probe_rows_per_sec']:.0f} probe rows/s, "
        f"{out['result_rows']} pairs, launches {launches}")
    if out["verified"] is not True:
        raise AssertionError(f"{cfg.name}: result fails the oracle")
    if not out["result_rows"] > 0:
        raise AssertionError(f"{cfg.name}: no pairs")
    for name in path:
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no launch during {cfg.name}")
    for name in record:
        results[name]["launches"] = launches[name]
    return out


def _counted(fn, path: tuple, what: str):
    """Run ``fn`` with the counters from 0 just before it; every kernel of
    ``path`` must launch. Returns (fn's result, the counters)."""
    zero_counters()
    out = fn()
    launches = read_counters()
    for name in path:
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no launch during {what}")
    return out, launches


def ops_phase(dev, results: dict) -> None:
    """The filter and the aggregate through tpujoin_torch.bench at OP_ROWS
    rows, verified; the nested-loop join and the other new entry points
    on the card by default (numpy input), against the oracle and the CPU
    path."""
    out, launches = _counted(
        lambda: bench.bench_filter(OP_ROWS, verify=True, device=dev),
        ("compact_ids",), "the filter")
    print(json.dumps(out), flush=True)
    if out["verified"] is not True:
        raise AssertionError("filter: result fails its check")
    results["compact_ids"]["launches"] = launches["compact_ids"]
    say("ops", f"filter {OP_ROWS} rows: {out['total_seconds']:.6f} s, "
        f"{out['rows_per_sec']:.0f} rows/s, verified; launches {launches}")

    t0 = time.perf_counter()
    out, launches = _counted(
        lambda: bench.bench_aggregate(OP_ROWS, OP_ROWS // 10, verify=True,
                                      device=dev),
        ("compact_ids", "compact_cols"), "the aggregate")
    print(json.dumps(out), flush=True)
    if out["verified"] is not True:
        raise AssertionError("aggregate: result fails its check")
    results["compact_cols"]["launches"] = launches["compact_cols"]
    say("ops", f"aggregate {OP_ROWS} rows, {out['groups']} groups: count + "
        f"materialize {out['total_seconds']:.6f} s, values "
        f"{out['agg_values_seconds']:.6f} s, verified; "
        f"{time.perf_counter() - t0:.3f} s with the host check; "
        f"launches {launches}")

    rng = np.random.default_rng(3)
    rk = rng.integers(1, 4097, 8192).astype(np.int32)
    sk = rng.integers(1, 4097, 8192).astype(np.int32)
    (r, s), launches = _counted(lambda: tpujoin_torch.nested_loop_join(rk, sk),
                                ("compact_ids",), "the nested-loop join")
    r_cpu, s_cpu = tpujoin_torch.nested_loop_join(rk, sk, device="cpu")
    if (oracle.check_join(rk, sk, r, s, nested=True) != 1
            or not (np.array_equal(r, r_cpu) and np.array_equal(s, s_cpu))):
        raise AssertionError("nested-loop join on the card fails the oracle")
    say("ops", f"nested-loop join 8192 x 8192, keys 1..4096: {len(r)} pairs,"
        f" oracle PASS, equal to the CPU path; {launches['compact_ids']} "
        f"compact_ids launch(es)")

    keys = rng.integers(1, 5001, 1 << 16).astype(np.int32)
    vals = rng.integers(-2**31, 2**31 - 1, 1 << 16).astype(np.int32)
    table = {"key": keys, "val": vals}
    for name, fn, path in (
            ("filter_table", lambda **kw: tuple(tpujoin_torch.filter_table(
                table, lambda v: v < 0, "val", return_numpy=True,
                **kw).values()), ("compact_ids",)),
            ("group_by_count", lambda **kw: tpujoin_torch.group_by_count(
                keys, **kw), ("compact_ids",)),
            ("group_by_agg", lambda **kw: tpujoin_torch.group_by_agg(
                keys, vals, **kw), ("compact_cols",))):
        got, _ = _counted(fn, path, name)
        want = fn(device="cpu")
        if not all(np.array_equal(g, w) for g, w in zip(got, want,
                                                         strict=True)):
            raise AssertionError(f"{name} on the card differs from the CPU")
        say("ops", f"{name} 65536 rows on the card by default: equal to the "
            f"CPU path")


def check_dense_slice(out: dict) -> None:
    """The dense slice materialized every pair on fill and checked each."""
    if out.get("pair_kernel") != "fill":
        raise AssertionError(f"dense slice took {out.get('pair_kernel')!r}")
    if out.get("pairs_checked") != out["result_rows"]:
        raise AssertionError(f"dense slice checked {out.get('pairs_checked')}"
                             f" of {out['result_rows']} pairs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpujoin_torch smoke run")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale of the low-selectivity slice")
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
        "expand_fill": {"source": src + "expand_pairs.cu",
                        "replaces": "tpujoin/kernels/expand_fill.py:208"},
        "expand_groups": {"source": src + "expand_pairs.cu",
                          "replaces": "tpujoin/kernels/expand_groups.py:264"},
        "expand_runs": {"source": src + "expand_pairs.cu",
                        "replaces": "tpujoin/kernels/expand_runs.py:131"},
        "compact_ids": {"source": src + "compact.cu",
                        "replaces": "tpujoin/kernels/compact.py:342"},
        "compact_cols": {"source": src + "compact.cu",
                         "replaces": "tpujoin/kernels/compact.py:462"},
    }
    low = bench.scaled_config("ref_low_selectivity", args.scale)
    high = bench.scaled_config("ref_high_selectivity")
    phases = (
        lambda: kernels_phase(dev, low, results),
        lambda: dense_kernels_phase(dev, high, results),
        lambda: runs_phase(dev, results),
        lambda: slice_phase(dev, low, results, path=(
            "block_sort", "merge_pass", "merge_count", "compact3", "expand"),
            record=("block_sort", "merge_pass", "merge_count", "compact3",
                    "expand")),
        lambda: check_dense_slice(slice_phase(dev, high, results, path=(
            "block_sort", "merge_pass", "merge_count", "expand_fill"),
            record=("expand_fill",))),
        lambda: k6_phase(dev, results),
        lambda: ops_phase(dev, results),
    )
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        torch.cuda.empty_cache()
        say("time", f"{time.perf_counter() - t0:.3f} s")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        for name, r in results.items()]}), flush=True)
    say("wall", f"{time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
