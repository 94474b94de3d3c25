#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpujoin_torch) on one CUDA card.

Phases, one line each (details on stderr):
  1. device   the card, and its name and power limit from nvidia-smi;
  2. build    nvcc builds every kernel of tpujoin_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card, on
              the inputs the main paths give it, bitwise, and the time of
              both (CUDA events, the minimum of 5 runs after a warm-up,
              each queued behind a device-side hold so that the events
              time the device and not the host's launches):
              K1-K4 on ref_low_selectivity's keys (sorted, counted,
              compacted: K1's histogram and each digit pass on the keys as
              they arrive at its digit, sort_pairs on both sides, timed
              beside torch.sort(stable=True); K2's co-rank pass and count
              kernel, and K4's partition pass and fill kernel, each timed
              under torch.profiler beside the whole call), K2 on
              zipf_skew's keys (10M x 10M, Zipf(1.0)), then K1 on a ragged
              width with the i32 extremes and a small join checked against
              the native oracle; sort_pairs on ref_high_selectivity's build
              keys, timed beside torch.sort, and K2 on its sorted keys; K5
              and
              K7 (expand_fill, expand_groups, expand_runs) on
              ref_high_selectivity's count state at its full capacity
              (~1e9 slots), K5's partition pass and fill kernel each
              timed under torch.profiler beside the whole call, K5 again
              on a state of 2^26 one-slot runs (groups from offset > 0,
              periods 1 to above a tile, a ragged capacity), and
              probe_materialize_groups on the dense state, which is
              expand_groups' path;
  4. runs     a 4096 x 4096 join with ~16 matches per row through
              merge_join on the card: the runs path (expand_runs), checked
              against the oracle and the CPU path;
  5. matrix   tpujoin_torch.bench's default matrix at full size through
              run_matrix, the function its main runs: v2 on
              ref_low_selectivity (100M x 100M) and ref_high_selectivity
              (10M x 10M, ~1e9 pairs), v1 on ref_low_selectivity, v1's
              factorized result on ref_high_selectivity, v2 on zipf_skew,
              then the multi-column join with filter pushdown at 100M rows
              a side; every entry verified (the native oracle on every
              pair; for the dense entries the RLE oracle, and for v2's
              window checksums of every slot), each entry's kernels'
              launch counters above 0 for its run, from 0 just before it;
              then the summary line: it parses, fits 1900 bytes and holds
              six verified configs;
     v1       tpujoin_torch.hash_join on the card from numpy keys, a dense
              join (262,144 x 262,144, ~2^24 pairs) whose materialize
              fills its row markers with fill_forward, against the oracle
              and the CPU path, and fill_forward on that marker column
              against its plain version; then the bench's v1 dense cell on
              ref_high_selectivity (4 probe chunks, every pair checked by
              the multiset checksum);
     split    semi_join, anti_join and left_outer_join on the card from
              numpy keys at ref_low_selectivity's full width, against
              torch.isin and a pair count on the card (compact_ids
              launched), then at 1/100 of it against the CPU path;
     tables   hash_join_multi and join_with_pushdown at 2M rows a side
              against the CPU path (compact3 launched in the pushdown),
              join_tables for each how on one and two keys against the CPU
              path, and an npz and a raw-directory round trip joined after
              loading;
  6. k6       K6a compact_ids and K6b compact_cols against their plain
              versions on the filter's and the aggregate's own 100M-row
              inputs, bitwise and timed, with torch.nonzero beside K6a;
  7. ops      tpujoin_torch.bench's filter at 100M rows and aggregate at
              10M (cut from 100M to hold the wall), verified (numpy; the native group count and a numpy
              recompute of every group's sum, min and max), an 8192 x 8192
              nested-loop join on the card from numpy keys against the
              oracle and the CPU path, and filter_table, group_by_count and
              group_by_agg on the card by default against the CPU path;
              each run's kernels' launch counters above 0;
  8. probes   the probe kernels against their plain versions on the probe
              programs' own inputs, bitwise and timed: stream_scale on
              bench/primitives.py's 99,614,720 rows and on the i32
              extremes, smem_gather 65,536 from 16,384, carry_scan on 2^30
              ones and on 2^30 full-range values,
              shift_loop on 2^28 rows at rolls 1, 4, 10 and 20; then both
              probe programs (tpujoin_torch.probes.primitives and
              .bench_mat2) at full size, each kernel's launch counter above
              0 for that run;
  9. variants the design-probe kernels against their plain versions on
              their programs' own full-size inputs, bitwise and timed:
              merge_count_v, every strategy, on the count_variants
              program's sorted keys (ref_low, 100M x 100M in [1, 1e9], with
              K2 merge_count timed on the same keys, and ref_high),
              expand_fill_v, every variant, on fill_variants' 999,100,000
              slots, run_variant, every variant, on profile_expand_runs'
              100M slots, and fill_forward at steps 16K, 32K and 64K on
              probe_fill's marker column (~1e9 slots); then the four
              programs at full size, each kernel's launch counter above 0
              for its program's run;
 10. costs    the cost-probe kernels against their plain versions at their
              programs' full sizes, bitwise and timed: op_chain, every kind
              at R = 16, 64, 256 and 512 (64 ops, 512 repetitions), the row
              kinds again at 5 ops where 64 are the identity, a folding
              guard (128 ops against 64, and 512 repetitions against 256,
              must take >= 1.5x the time), and at R = 256 roll_sub, the
              kernels line's entry, the plain version over all 512
              repetitions and torch.roll by the composed shift; select_chain on 2^28 rows, every R and op count of
              the program; flat_roll on 2^28 rows at rolls 1, 4, 10 and 20,
              and at shifts around the tile, negative and i32-large; then
              the three programs at full size, each kernel's launch counter
              above 0 for its program's run;
 11. mosaic   the ten capability-probe kernels (roll, smem_dyn, vmem_dyn,
              fori, smem_block, hbm_to_smem, dyn_vec_load, sublane_roll,
              row_dma_2d, flat_rotate; hbm_to_smem a TMA copy) against
              their plain versions at their programs' inputs, bitwise and
              timed, with the one PyTorch call that computes the same
              function where there is one, then at each program's EDGES
              scalars on full-range data (shifts 0, -1, 1023, 1024 and the
              i32 ends; offsets at both ends of a copy's precondition and
              past them); row_dma_2d, sublane_roll and dyn_vec_load and
              their library calls three times each, in turns; the host's
              time a call of the TMA copy beside two kernels without one;
              then the three programs
              (tpujoin_torch.probes.probe_mosaic, 2 and 3) at full size,
              each kernel's launch counter above 0 for its program's run.
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
import tempfile
import time

import numpy as np
import torch

import tpujoin_torch
from tpujoin_torch import bench, merge_join, oracle
from tpujoin_torch.core import datagen
from tpujoin_torch.core import io as table_io
from tpujoin_torch.kernels import (_build, carry_scan, compact, expand,
                                   expand_fill, expand_groups, expand_runs,
                                   fill_phases, flat_roll, forward_fill,
                                   merge_count, merge_sort, mosaic, mosaic2,
                                   mosaic3, op_chain, runs_phases,
                                   select_chain, shift_loop, slab_count,
                                   smem_gather, stream)
from tpujoin_torch.ops import aggregate as agg
from tpujoin_torch.ops import hash_join as hj
from tpujoin_torch.ops import merge_join as mj
from tpujoin_torch.ops.hash_join import build
from tpujoin_torch.probes import (bench_mat2, count_variants, fill_variants,
                                  primitives, probe_fill, probe_flatroll,
                                  probe_mosaic, probe_mosaic2, probe_mosaic3,
                                  probe_opcost, profile_expand_runs,
                                  roll_cost)
from tpujoin_torch.utils.hw import hbm_peak_gbps
from tpujoin_torch.utils.shapes import round_up

IMAX = 2**31 - 1
OP_ROWS = 100_000_000        # the filter's and the aggregate's rows
# the ops phase's verified aggregate, cut from OP_ROWS to hold the wall as
# the matrix joined the run (its host check took 43 s at 100M rows); K6a
# and K6b still run on the 100M-row aggregate inputs in the k6 phase
AGG_ROWS = 10_000_000
PRIMITIVE_ROWS = 100_000_000  # bench/primitives.py's N
CHUNK = 1 << 26              # elements per step of the kernel/plain compare
HOLD_MS = 10.0               # the device-side wait before each timed run
HOLD_DOUBLINGS = 4           # longer holds tried before a run is flagged
# the data sheet's fp32 rate outside the tensor cores: it lists no i32
# rate, and these kernels' compares and adds are i32
OPS_PER_S = 67e12


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, label: str, reps: int = 5) -> float:
    """Minimum over ``reps`` CUDA-event-timed runs of ``fn``, in ms.

    Each run is queued behind a device-side spin (``torch.cuda._sleep``, a
    private PyTorch call) of HOLD_MS at the card's reported SM clock, so the
    host has enqueued the run before the start event fires and the events
    time the device's work, not the launches' host overhead. If the start
    event has already fired when ``fn`` returns, the hold did not cover the
    enqueue: the run is dropped and tried again behind a hold twice as long.
    A run that still is not covered after HOLD_DOUBLINGS doublings waits on
    the device inside ``fn`` (a host sync, as ``torch.nonzero`` has); it is
    timed as it is and flagged, since its events include host work."""
    fn()
    torch.cuda.synchronize()
    khz = torch.cuda.get_device_properties(0).clock_rate
    cycles = max(1, int(khz * HOLD_MS))
    best, doublings, done = math.inf, 0, 0
    while done < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        if not covered and doublings < HOLD_DOUBLINGS:
            cycles, doublings = 2 * cycles, doublings + 1
            continue
        if not covered and done == 0:
            say("timing", f"{label}: waits on the device inside the timed "
                f"run even behind a {cycles / khz:.0f} ms hold; its time "
                f"includes host work")
        best = min(best, start.elapsed_time(end))
        done += 1
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
    got = {"max_abs_err": err, "ms": cuda_ms(run, name),
           "plain_ms": cuda_ms(plain, f"{name} plain")}
    if results is not None:
        results[name].update(got)
    say(phase, f"{name}: exact; {got['ms']:.3f} ms (plain "
        f"{got['plain_ms']:.3f} ms)")
    return got


def hbm_bytes_per_s() -> float:
    """The card's HBM peak from its name (tpujoin_torch/utils/hw.py), in
    bytes/s; raises for a card it does not know."""
    gbps = hbm_peak_gbps(torch.device("cuda", 0))
    if not gbps:
        raise RuntimeError(f"no HBM peak known for "
                           f"{torch.cuda.get_device_name(0)}")
    return gbps * 1e9


def bound(results: dict, name: str, nbytes: float, ops: float,
          sms: int | None = None) -> None:
    """Record the least time the card could take for ``name``'s work: the
    larger of its bytes (each input read once, each output written once)
    over the HBM rate and its operations over the op rate, that of ``sms``
    SMs where the kernel runs on so few by design, else the card's."""
    rate = OPS_PER_S
    if sms is not None:
        rate *= sms / torch.cuda.get_device_properties(0).multi_processor_count
    by_bytes = nbytes / hbm_bytes_per_s() * 1e3
    by_ops = ops / rate * 1e3
    results[name].update(
        bound_ms=max(by_bytes, by_ops),
        bound_by="bytes" if by_bytes >= by_ops else "operations")


def kernel_ms(fn, names: tuple, reps: int = 5) -> dict:
    """Device ms of each kernel whose name holds one of ``names``: the
    least over ``reps`` runs of ``fn`` under torch.profiler (device rows
    only). Raises if one of them did not run."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    best = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for key in names:
            if key in e.name:
                best[key] = min(best.get(key, math.inf),
                                e.time_range.elapsed_us() / 1e3)
    missing = [key for key in names if key not in best]
    if missing:
        raise AssertionError(f"the profiler saw no {missing} kernel")
    return best


def one_slot_state(slots: int, dev, seed: int = 9):
    """expand_fill's inputs for ``slots`` one-slot runs, each tile meeting
    TILE + 1 runs: ~slots / 64 groups from offset 1 on (the slots before
    the first group take the canonical negative phase), periods 1 to
    300, every 97th above a tile, over 2^22 source ids; the capacity is no
    multiple of the tile."""
    g = torch.Generator(device=dev).manual_seed(seed)
    roff = torch.arange(slots, dtype=torch.int32, device=dev)
    rsid = torch.randperm(slots, generator=g, device=dev).to(torch.int32)
    heads = torch.nonzero(torch.rand(slots, generator=g, device=dev)
                          < 1 / 64).flatten()
    goff = heads[heads > 0].to(torch.int32)
    ngroups, n = goff.shape[0], 1 << 22
    gnb = torch.randint(1, 301, (ngroups,), generator=g, device=dev,
                        dtype=torch.int32)
    gnb[::2] = 1
    gnb[::97] = expand_fill.TILE + 1
    glo = torch.randint(-8, n - 8, (ngroups,), generator=g, device=dev,
                        dtype=torch.int32)
    src = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    return (roff, rsid, goff, glo, gnb, src, slots, ngroups, slots,
            slots + expand_fill.TILE // 2 + 5)


def check_sort_pairs(keys, ids, what: str, timed: bool = False):
    """K1's sort_pairs bitwise against sort_pairs_plain (keys and ids);
    with ``timed``, both and one torch.sort(stable=True) timed beside it.
    Returns the kernels' result."""
    got = merge_sort.sort_pairs(keys, ids)
    err = max_abs_err(got, merge_sort.sort_pairs_plain(keys, ids))
    if err:
        raise AssertionError(f"sort_pairs ({what}) differs from its plain "
                             f"version: {err}")
    n = keys.shape[0]
    line = f"sort_pairs n={n} ({what}): exact"
    if timed:
        pairs_ms = cuda_ms(lambda: merge_sort.sort_pairs(keys, ids),
                           "sort_pairs")
        plain_ms = cuda_ms(lambda: merge_sort.sort_pairs_plain(keys, ids),
                           "sort_pairs plain")
        torch_ms = cuda_ms(lambda: torch.sort(keys, stable=True),
                           "torch.sort")
        floor_ms = (4 * n + 4 * 16 * n) / hbm_bytes_per_s() * 1e3
        line += (f"; {pairs_ms:.6f} ms, histogram + 4 passes (floor "
                 f"{floor_ms:.6f} ms; torch.sort + gather {plain_ms:.6f} "
                 f"ms; one torch.sort(stable=True), whose indices are the "
                 f"ids here, {torch_ms:.6f} ms)")
    say("kernels", line)
    return got


def kernels_phase(dev, cfg, results: dict) -> None:
    """K1-K4 against their plain versions on the inputs the main path
    gives them for ``cfg``: both sorts of the keys, the count of the sorted
    probe keys in the sorted build keys, and the compaction and expansion
    of that count state; then K1 on a ragged width with the i32 extremes,
    and a small join against the oracle."""
    bk, pk = bench.config_keys(cfg, dev)
    n = bk.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    check_kernel("sort_histogram",
                 lambda: (merge_sort.sort_histogram(bk),),
                 lambda: (merge_sort.sort_histogram_plain(bk),), results)
    bound(results, "sort_histogram", 4 * n + 4 * 4 * 256, 4 * n)
    # each digit pass on the keys as they arrive at its digit; the entry
    # keeps the slowest pass
    hist = merge_sort.sort_histogram(bk)
    k, i, passes = bk, ids, []
    for shift in merge_sort.SHIFTS:
        got = check_kernel(
            f"sort_pass[shift {shift}]",
            lambda k=k, i=i, s=shift: merge_sort.sort_pass(k, i, s, hist),
            lambda k=k, i=i, s=shift: merge_sort.sort_pass_plain(k, i, s),
            None)
        passes.append((got["ms"], shift, got))
        k, i = merge_sort.sort_pass_plain(k, i, shift)
    slowest_ms, slowest_shift, slowest = max(passes, key=lambda p: p[0])
    results["sort_pass"].update(slowest)
    bound(results, "sort_pass", 16 * n, n)
    say("kernels", f"sort_pass: slowest at shift {slowest_shift}, "
        f"{slowest_ms:.3f} ms; bound "
        f"{results['sort_pass']['bound_ms']:.3f} ms a pass")
    del k, i, hist, passes
    bsk, _ = check_sort_pairs(bk, ids, "build side", timed=True)
    m = pk.shape[0]
    pids = torch.arange(m, dtype=torch.int32, device=dev)
    psk, psid = check_sort_pairs(pk, pids, "probe side")
    del bk, pk, ids, pids

    check_count(bsk, psk, cfg.name, results)
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
    split = kernel_ms(lambda: expand.expand(offs, lo_c, sid_c, capacity),
                      ("partition_kernel", "expand_fill_kernel"))
    say("kernels", f"expand at {capacity} slots: partition pass "
        f"{split['partition_kernel']:.6f} ms, fill kernel "
        f"{split['expand_fill_kernel']:.6f} ms (torch.profiler, least of "
        f"5), whole call {results['expand']['ms']:.6f} ms (events); bound "
        f"{results['expand']['bound_ms']:.6f} ms")
    say("kernels", f"main-path widths: {n} x {m} keys, nonzero={nonzero} "
        f"k_cap={k_cap} total={total} capacity={capacity}")
    del lo_c, cnt_c, sid_c, offs

    # K2 on zipf_skew's keys (10M x 10M, Zipf(1.0) over [1, 1e6])
    bk, pk = bench.config_keys(bench.scaled_config("zipf_skew"), dev)
    check_count(torch.sort(bk).values, torch.sort(pk).values, "zipf_skew")
    del bk, pk

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
    hist = merge_sort.sort_histogram(keys)
    if max_abs_err((hist,), (merge_sort.sort_histogram_plain(keys),)):
        raise AssertionError("sort_histogram differs from its plain version "
                             "on the i32 extremes")
    k, i = keys, ids
    for shift in merge_sort.SHIFTS:
        want = merge_sort.sort_pass_plain(k, i, shift)
        if max_abs_err(merge_sort.sort_pass(k, i, shift, hist), want):
            raise AssertionError(f"sort_pass at shift {shift} differs from "
                                 f"its plain version on the i32 extremes")
        k, i = want
    check_sort_pairs(keys, ids, "i32 extremes")
    del keys, ids, hist, k, i, want

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


def check_count(bsk, psk, what: str, results: dict | None = None) -> None:
    """K2 bitwise against merge_count_plain on sorted keys, timed, and its
    co-rank pass and count kernel timed apart under torch.profiler; the
    kernels line's entry when ``results`` is given."""
    n, m = bsk.shape[0], psk.shape[0]
    name = "merge_count" if results is not None else f"merge_count[{what}]"
    got = check_kernel(name, lambda: merge_count.merge_count(bsk, psk),
                       lambda: merge_count.merge_count_plain(bsk, psk),
                       results)
    if results is not None:
        bound(results, name, 4 * n + 12 * m, n + m)
        lo, cnt = merge_count.merge_count(bsk, psk)
        if max_abs_err((lo, cnt), v1_count(bsk, psk)):
            raise AssertionError("merge_count differs from v1's two "
                                 "torch.searchsorted")
        del lo, cnt
        results[name]["library_ms"] = cuda_ms(
            lambda: v1_count(bsk, psk), "two torch.searchsorted")
    split = kernel_ms(lambda: merge_count.merge_count(bsk, psk),
                      ("corank_kernel", "merge_count_kernel"))
    floor = (4 * n + 12 * m) / hbm_bytes_per_s() * 1e3
    say("kernels", f"merge_count {what} {n} x {m}: co-rank pass "
        f"{split['corank_kernel']:.6f} ms, count kernel "
        f"{split['merge_count_kernel']:.6f} ms (torch.profiler, least of "
        f"5), whole call {got['ms']:.6f} ms (events); bound {floor:.6f} ms")


def v1_count(bsk, psk):
    """(lo, cnt) of the probe keys in the sorted build keys by two
    torch.searchsorted, the v1 engine's count (tpujoin_torch/ops/
    hash_join.py:probe_count): merge_count's library call."""
    lo = torch.searchsorted(bsk, psk, out_int32=True)
    return lo, torch.searchsorted(bsk, psk, right=True, out_int32=True) - lo


def same_pairs(r, s, r2, s2) -> bool:
    """Whether two numpy pair columns hold the same pair multiset."""
    return np.array_equal(np.sort(r.astype(np.int64) << 32 | s),
                          np.sort(r2.astype(np.int64) << 32 | s2))


def dense_kernels_phase(dev, cfg, results: dict) -> None:
    """K1's sort_pairs on ``cfg``'s build keys, bitwise and timed beside
    torch.sort; then K5 and K7 against their plain versions on the inputs
    the dense path gives them for ``cfg``: its keys sorted and counted,
    the RLE form and group heads, at the full capacity; then
    probe_materialize_groups on that state, expand_groups' path, counted
    and held against fill's columns."""
    bk, pk = bench.config_keys(cfg, dev)
    check_sort_pairs(bk, torch.arange(bk.shape[0], dtype=torch.int32,
                                      device=dev), "build side", timed=True)
    ht = build(bk)
    check_count(ht.sorted_keys, torch.sort(pk).values, cfg.name)
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
    split = kernel_ms(lambda: expand_fill.expand_fill(*fill_args),
                      ("partition_kernel", "expand_fill_kernel"))
    say("kernels", f"expand_fill at {cap} slots: partition pass "
        f"{split['partition_kernel']:.6f} ms, fill kernel "
        f"{split['expand_fill_kernel']:.6f} ms (torch.profiler, least of "
        f"5), whole call {results['expand_fill']['ms']:.6f} ms (events); "
        f"bound {results['expand_fill']['bound_ms']:.6f} ms")
    del fill_args, runs_args
    torch.cuda.empty_cache()
    one_slot = one_slot_state(1 << 26, dev)
    check_kernel(f"expand_fill[{1 << 26} one-slot runs]",
                 lambda: expand_fill.expand_fill(*one_slot),
                 lambda: expand_fill.expand_fill_plain(*one_slot), None)
    del one_slot
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
        lambda: torch.nonzero(mask), "torch.nonzero")
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
        f"{gcap}; bound {(OP_ROWS + 4 * gcap) / hbm_bytes_per_s() * 1e3:.3f} "
        f"ms; torch.nonzero "
        f"{cuda_ms(lambda: torch.nonzero(starts), 'torch.nonzero'):.3f} ms"
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


COUNTERS = {"sort_histogram": (merge_sort, "HIST_LAUNCHES"),
            "sort_pass": (merge_sort, "PASS_LAUNCHES"),
            "merge_count": (merge_count, "LAUNCHES"),
            "compact3": (compact, "LAUNCHES"),
            "expand": (expand, "LAUNCHES"),
            "expand_fill": (expand_fill, "LAUNCHES"),
            "expand_groups": (expand_groups, "LAUNCHES"),
            "expand_runs": (expand_runs, "LAUNCHES"),
            "compact_ids": (compact, "IDS_LAUNCHES"),
            "compact_cols": (compact, "COLS_LAUNCHES"),
            "stream_scale": (stream, "LAUNCHES"),
            "smem_gather": (smem_gather, "LAUNCHES"),
            "carry_scan": (carry_scan, "LAUNCHES"),
            "shift_loop": (shift_loop, "LAUNCHES"),
            "merge_count_v": (slab_count, "LAUNCHES"),
            "expand_fill_v": (fill_phases, "LAUNCHES"),
            "run_variant": (runs_phases, "LAUNCHES"),
            "fill_forward": (forward_fill, "LAUNCHES"),
            "op_chain": (op_chain, "LAUNCHES"),
            "select_chain": (select_chain, "LAUNCHES"),
            "flat_roll": (flat_roll, "LAUNCHES"),
            "roll": (mosaic, "ROLL_LAUNCHES"),
            "smem_dyn": (mosaic, "SMEM_DYN_LAUNCHES"),
            "vmem_dyn": (mosaic, "VMEM_DYN_LAUNCHES"),
            "fori": (mosaic, "FORI_LAUNCHES"),
            "smem_block": (mosaic, "SMEM_BLOCK_LAUNCHES"),
            "hbm_to_smem": (mosaic2, "HBM_TO_SMEM_LAUNCHES"),
            "dyn_vec_load": (mosaic2, "DYN_VEC_LOAD_LAUNCHES"),
            "sublane_roll": (mosaic3, "SUBLANE_ROLL_LAUNCHES"),
            "row_dma_2d": (mosaic3, "ROW_DMA_2D_LAUNCHES"),
            "flat_rotate": (mosaic3, "FLAT_ROTATE_LAUNCHES")}


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


# each matrix entry's kernels, which must launch in its run, and those
# whose launches go into the kernels line (from the entry that runs them
# on a reference config)
MATRIX_PATHS = {
    "ref_low_selectivity": ("sort_histogram", "sort_pass", "merge_count",
                            "compact3", "expand"),
    "ref_high_selectivity": ("sort_histogram", "sort_pass", "merge_count",
                             "expand_fill"),
    "ref_low_selectivity[v1]": ("sort_histogram", "sort_pass"),
    "ref_high_selectivity[v1-rle]": ("sort_histogram", "sort_pass"),
    "zipf_skew": ("sort_histogram", "sort_pass", "merge_count"),
    "multi_join": ("sort_histogram", "sort_pass", "merge_count", "compact3",
                   "expand", "compact_ids"),
}
MATRIX_RECORD = {"ref_low_selectivity": MATRIX_PATHS["ref_low_selectivity"],
                 "ref_high_selectivity": ("expand_fill",)}


def matrix_phase(dev, results: dict, scale: float) -> None:
    """tpujoin_torch.bench's default matrix through run_matrix, the
    function its main runs, every entry verified, with the counters from 0
    just before each entry; each entry's kernels must launch, the dense
    v2 entry materializes every pair on fill and checks each; then the
    summary line: it parses, fits 1900 bytes and holds six verified
    configs."""
    def run(key, fn):
        t0 = time.perf_counter()
        out, launches = _counted(fn, MATRIX_PATHS[key], key)
        if out["verified"] is not True:
            raise AssertionError(f"{key}: result fails its check")
        if not out["result_rows"] > 0:
            raise AssertionError(f"{key}: no pairs")
        if key == "ref_high_selectivity":
            check_dense_slice(out)
        for name in MATRIX_RECORD.get(key, ()):
            results[name]["launches"] = launches[name]
        phases = ", ".join(f"{k} {out[k]:.6f} s" for k in (
            "build_seconds", "count_seconds", "materialize_seconds",
            "rle_result_seconds", "pair_materialize_seconds",
            "join_seconds", "pushdown_seconds") if k in out)
        rate = out.get("probe_rows_per_sec", out.get("rows_per_sec"))
        say("matrix", f"{key}: {phases}; {rate:.0f} rows/s, "
            f"{out['result_rows']} pairs, verified; "
            f"{time.perf_counter() - t0:.3f} s with its checks; launches "
            + ", ".join(f"{k} {launches[k]}" for k in MATRIX_PATHS[key]))
        return out

    completed = {}
    bench.run_matrix(bench.matrix_entries(), completed, verify=True,
                     scale=scale, multi_join=True, device=dev, run=run)
    line = bench._summary_line(completed, True)
    summary = json.loads(line)
    if (len(line) > 1900 or summary["metric"] != "hash_join_probe_rows_per_sec"
            or summary["verified"] is not True
            or len(summary["configs"]) != 6):
        raise AssertionError(f"summary line: {line}")
    say("matrix", f"summary line: {len(line)} bytes, "
        f"{len(summary['configs'])} configs, verified")


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
    """The filter through tpujoin_torch.bench at OP_ROWS rows and the
    aggregate at AGG_ROWS, verified; the nested-loop join and the other new entry points
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
        lambda: bench.bench_aggregate(AGG_ROWS, AGG_ROWS // 10,
                                      verify=True, device=dev),
        ("compact_ids", "compact_cols"), "the aggregate")
    print(json.dumps(out), flush=True)
    if out["verified"] is not True:
        raise AssertionError("aggregate: result fails its check")
    results["compact_cols"]["launches"] = launches["compact_cols"]
    say("ops", f"aggregate {AGG_ROWS} rows (cut from {OP_ROWS} to hold "
        f"the wall), {out['groups']} groups: count + "
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


V1_ROWS = 1 << 18            # a side of the v1 phase's dense join
V1_KEYS = 4096               # its key domain: ~2^24 pairs, capacity >= m


def v1_phase(dev, results: dict) -> None:
    """The v1 engine: tpujoin_torch.hash_join on the card by default from
    numpy keys, a dense join (capacity >= probe rows), so its materialize
    fills the row markers with fill_forward; against the oracle and the
    CPU path, and fill_forward on that marker column against its plain
    version. Then the bench's v1 dense cell on ref_high_selectivity (4
    probe chunks, every pair checked by the multiset checksum)."""
    rng = np.random.default_rng(4)
    bk = rng.integers(1, V1_KEYS + 1, V1_ROWS).astype(np.int32)
    pk = rng.integers(1, V1_KEYS + 1, V1_ROWS).astype(np.int32)
    (r, s), launches = _counted(lambda: tpujoin_torch.hash_join(bk, pk),
                                ("sort_histogram", "sort_pass",
                                 "fill_forward"), "hash_join")
    r_cpu, s_cpu = tpujoin_torch.hash_join(bk, pk, device="cpu")
    if oracle.check_join(bk, pk, r, s) != 1 or not same_pairs(r, s, r_cpu,
                                                              s_cpu):
        raise AssertionError("v1 hash_join on the card fails the oracle")
    ht = build(torch.from_numpy(bk).to(dev))
    lo, counts = hj.probe_count(ht, torch.from_numpy(pk).to(dev))
    offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    cap = round_up(len(r), 1 << 20)
    mark = hj.row_markers(offsets, counts, cap)
    got = check_kernel(
        f"fill_forward[v1, {mark.numel()} slots]",
        lambda: (forward_fill.fill_forward(mark, hj.FILL_STEP),),
        lambda: (forward_fill.fill_forward_plain(mark, hj.FILL_STEP),),
        None, "v1")
    say("v1", f"hash_join {V1_ROWS} x {V1_ROWS}, keys 1..{V1_KEYS}: "
        f"{len(r)} pairs, capacity {cap} >= {V1_ROWS} probe rows (dense), "
        f"oracle PASS, the CPU path's multiset; {launches['fill_forward']} "
        f"fill_forward launch(es), max |err| {got['max_abs_err']} against "
        f"its plain version on the marker column")
    del ht, lo, counts, offsets, mark

    cfg = bench.scaled_config("ref_high_selectivity")
    t0 = time.perf_counter()
    out, launches = _counted(
        lambda: bench.bench_join(cfg, True, "v1", dev),
        ("sort_histogram", "sort_pass", "fill_forward"), "the v1 dense cell")
    print(json.dumps(out), flush=True)
    if out["verified"] is not True or out["rle_verified"] is not True:
        raise AssertionError("v1 dense cell fails its check")
    if out.get("pairs_checked") != out["result_rows"]:
        raise AssertionError(f"v1 dense cell checked "
                             f"{out.get('pairs_checked')} of "
                             f"{out['result_rows']} pairs")
    say("v1", f"{cfg.name} v1 dense: {out['probe_chunks']} chunks, count "
        f"{out['count_seconds']:.6f} s, materialize "
        f"{out['materialize_seconds']:.6f} s, {out['result_rows']} pairs, "
        f"every pair checked; RLE result {out['rle_result_seconds']:.6f} s, "
        f"verified; {time.perf_counter() - t0:.3f} s with its checks; "
        f"{launches['fill_forward']} fill_forward launches")


def device_join_count(bk: torch.Tensor, pk: torch.Tensor) -> int:
    """|R join S| counted on the card by torch.sort and two
    torch.searchsorted, apart from the port's join."""
    srk = torch.sort(bk).values
    return int((torch.searchsorted(srk, pk, right=True)
                - torch.searchsorted(srk, pk)).sum())


def check_pair_set(bk, pk, r, s, what: str) -> None:
    """Pair columns on the card are the join exactly: every pair's keys
    equal, no pair twice, and as many pairs as device_join_count."""
    r, s = torch.from_numpy(r).to(bk.device), torch.from_numpy(s).to(
        bk.device)
    packed = torch.sort((r.long() << 32) | s.long()).values
    if (not bool((bk[r.long()] == pk[s.long()]).all())
            or bool((packed[1:] == packed[:-1]).any())
            or r.shape[0] != device_join_count(bk, pk)):
        raise AssertionError(f"{what}: not the join's pair set")


def split_phase(dev, scale: float) -> None:
    """semi_join, anti_join and left_outer_join on the card by default
    from numpy keys at ref_low_selectivity's full width, against
    torch.isin on the card and the count phase's nonzero; then at 1/100 of
    it against the CPU path."""
    cfg = bench.scaled_config("ref_low_selectivity", scale)
    bk, pk = bench.config_keys(cfg, dev)
    bk_np, pk_np = bk.cpu().numpy(), pk.cpu().numpy()
    t0 = time.perf_counter()
    semi, launches = _counted(lambda: tpujoin_torch.semi_join(bk_np, pk_np),
                              ("sort_pass", "merge_count", "compact_ids"),
                              "semi_join")
    anti = tpujoin_torch.anti_join(bk_np, pk_np)
    seconds = time.perf_counter() - t0
    in_build = torch.isin(pk, bk)
    nonzero = int(mj.probe_count(build(bk), pk)[2])
    if not (np.array_equal(semi, torch.nonzero(in_build).squeeze(1).cpu()
                           .numpy())
            and np.array_equal(anti, torch.nonzero(~in_build).squeeze(1)
                               .cpu().numpy())
            and len(semi) == nonzero):
        raise AssertionError("semi/anti split differs from torch.isin")
    (r, s), outer = _counted(
        lambda: tpujoin_torch.left_outer_join(bk_np, pk_np),
        ("compact3", "expand", "compact_ids"), "left_outer_join")
    inner = r >= 0
    k = int(inner.sum())
    if not (np.array_equal(s[k:], anti) and inner[:k].all()
            and not inner[k:].any()):
        raise AssertionError("left outer join: its null rows are not the "
                             "anti join")
    check_pair_set(bk, pk, r[inner], s[inner], "left outer join")
    say("split", f"{cfg.build_rows} x {cfg.probe_rows}: semi {len(semi)} "
        f"(= nonzero), anti {len(anti)}, equal to torch.isin on the card, "
        f"{seconds:.3f} s both; {launches['compact_ids']} compact_ids "
        f"launches in semi_join, {outer['compact_ids']} in "
        f"left_outer_join; left outer {int(inner.sum())} pairs, every pair "
        f"a match, none twice, as many as a count on the card, then "
        f"{len(anti)} null rows")
    del bk, pk, in_build

    small = bench.scaled_config("ref_low_selectivity", scale / 100)
    bk, pk = (x.cpu().numpy() for x in bench.config_keys(small, dev))
    for name in ("semi_join", "anti_join"):
        fn = getattr(tpujoin_torch, name)
        if not np.array_equal(fn(bk, pk), fn(bk, pk, device="cpu")):
            raise AssertionError(f"{name} on the card differs from the CPU")
    r, s = tpujoin_torch.left_outer_join(bk, pk)
    r2, s2 = tpujoin_torch.left_outer_join(bk, pk, device="cpu")
    k, k2 = int((r >= 0).sum()), int((r2 >= 0).sum())
    if not (np.array_equal(r[k:], r2[k2:]) and np.array_equal(s[k:], s2[k2:])
            and same_pairs(r[:k], s[:k], r2[:k2], s2[:k2])):
        raise AssertionError("left_outer_join on the card differs from the "
                             "CPU")
    say("split", f"{small.build_rows} x {small.probe_rows}: semi, anti "
        f"bitwise and left outer (its tail bitwise, its pairs as a "
        f"multiset) equal to the CPU path")


TABLE_ROWS = 20_000
MULTI_ROWS = 2_000_000       # a side of the multi-column joins here


def sorted_rows(cols: dict) -> dict:
    """A result table's numpy columns with its rows sorted by (s id, r id)
    where it has them, else as they are."""
    if "s_sid" in cols:
        order = np.lexsort((cols["r_rid"], cols["s_sid"]))
        return {k: v[order] for k, v in cols.items()}
    return cols


def tables_phase(dev) -> None:
    """hash_join_multi and join_with_pushdown on the card by default from
    numpy columns at MULTI_ROWS rows a side, against the CPU path, the
    pushdown's compact3 launched; join_tables for each ``how`` with one and
    two keys against the CPU path; an npz and a raw-directory round trip
    that joins after loading."""
    r, s = (t.to_numpy() for t in bench.multi_join_tables(MULTI_ROWS, dev))
    on = ["k1", "k2"]
    got = tpujoin_torch.hash_join_multi(r, s, on)
    want = tpujoin_torch.hash_join_multi(r, s, on, device="cpu")
    if not same_pairs(*got, *want) or not len(got[0]):
        raise AssertionError("hash_join_multi on the card differs")
    kw = {"r_pred": lambda v: v < 500, "r_pred_col": "v",
          "s_pred": lambda v: v < 500, "s_pred_col": "v"}
    pushed, launches = _counted(
        lambda: tpujoin_torch.join_with_pushdown(r, s, on, **kw),
        ("compact3", "merge_count", "compact_ids"), "join_with_pushdown")
    want = tpujoin_torch.join_with_pushdown(r, s, on, device="cpu", **kw)
    if not same_pairs(*pushed, *want) or not len(pushed[0]):
        raise AssertionError("join_with_pushdown on the card differs")
    say("tables", f"hash_join_multi {MULTI_ROWS} x {MULTI_ROWS} on (k1, k2):"
        f" {len(got[0])} pairs; join_with_pushdown (v < 500 a side): "
        f"{len(pushed[0])} pairs; both the CPU path's multiset; "
        f"{launches['compact3']} compact3 launches in the pushdown")

    rng = np.random.default_rng(5)
    n = TABLE_ROWS

    def table(rows, ids):
        return {"k1": rng.integers(1, 300, rows).astype(np.int32),
                "k2": rng.integers(1, 4, rows).astype(np.int32),
                ids: np.arange(rows, dtype=np.int32)}

    rt, st = table(n, "rid"), table(n + 7, "sid")
    for how in ("inner", "left", "semi", "anti"):
        for keys in ("k1", ["k1", "k2"]):
            out = tpujoin_torch.join_tables(rt, st, keys, how=how)
            cpu = tpujoin_torch.join_tables(rt, st, keys, how=how,
                                            device="cpu")
            a, b = sorted_rows(out.to_numpy()), sorted_rows(cpu.to_numpy())
            if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k])
                                               for k in a):
                raise AssertionError(f"join_tables {how} on {keys} differs "
                                     f"from the CPU")
    say("tables", f"join_tables {n} x {n + 7}: inner, left, semi, anti on "
        f"one and two keys, equal to the CPU path")

    with tempfile.TemporaryDirectory() as tmp:
        t = tpujoin_torch.Table.from_numpy(rt, dev)
        table_io.save_table_npz(t, f"{tmp}/t.npz")
        table_io.save_table_dir(t, f"{tmp}/tdir")
        for back in (table_io.load_table_npz(f"{tmp}/t.npz"),
                     table_io.load_table_dir(f"{tmp}/tdir"),
                     table_io.load_table_dir(f"{tmp}/tdir", mmap=False)):
            if back.device != dev or not all(
                    torch.equal(back[c], t[c]) for c in t.column_names):
                raise AssertionError("a table round trip differs")
            rr, ss = tpujoin_torch.merge_join(back["k1"], t["k1"])
            if oracle.check_join(rt["k1"], rt["k1"], rr, ss) != 1:
                raise AssertionError("a loaded table's join fails the "
                                     "oracle")
    say("tables", f"npz and raw-directory round trips (mmap and read) of "
        f"{n} rows on the card, each joined after loading: oracle PASS")


def full_range(n: int, seed: int, dev) -> torch.Tensor:
    """n i32 values over the whole range, seeded on the card, with both
    extremes present."""
    x = torch.randint(-IMAX - 1, IMAX, (n,),
                      generator=datagen.generator(seed, dev), device=dev,
                      dtype=torch.int32)
    x[::1001] = IMAX
    x[7::1003] = -IMAX - 1
    return x


def probes_phase(dev, results: dict) -> None:
    """The four probe kernels against their plain versions on the probe
    programs' own inputs (exact), timed, with the library call beside the
    three that have one; then both probe programs at full size, each
    kernel launched in its run."""
    data = primitives.inputs(PRIMITIVE_ROWS, dev)[0]
    x = data[:primitives.stream_rows(PRIMITIVE_ROWS)]
    del data
    n = x.shape[0]
    check_kernel("stream_scale", lambda: (stream.stream_scale(x),),
                 lambda: (stream.stream_scale_plain(x),), results, "probes")
    results["stream_scale"]["library_ms"] = cuda_ms(lambda: x * 2, "x * 2")
    bound(results, "stream_scale", 8 * n, n)
    ext = full_range((1 << 24) + 3, 5, dev)
    if max_abs_err((stream.stream_scale(ext),),
                   (stream.stream_scale_plain(ext),)):
        raise AssertionError("stream_scale differs on the i32 extremes")
    rate = 8 * n / (results["stream_scale"]["ms"] / 1e3)
    say("probes", f"stream_scale: {n} rows, {8 * n / 1e9:.6f} GB, "
        f"{rate / 1e9:.1f} GB/s ({rate / hbm_bytes_per_s():.4f} of the HBM "
        f"peak); exact on {ext.shape[0]} rows with the extremes")
    del x, ext

    tbl, vidx = primitives.gather_inputs(dev)
    check_kernel("smem_gather", lambda: (smem_gather.smem_gather(tbl, vidx),),
                 lambda: (smem_gather.smem_gather_plain(tbl, vidx),),
                 results, "probes")
    results["smem_gather"]["library_ms"] = cuda_ms(
        lambda: torch.index_select(tbl, 0, vidx), "torch.index_select")
    bound(results, "smem_gather", 4 * tbl.shape[0] + 8 * vidx.shape[0],
          vidx.shape[0])
    del tbl, vidx

    n = bench_mat2.N
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    check_kernel("carry_scan", lambda: (carry_scan.carry_scan(ones),),
                 lambda: (carry_scan.carry_scan_plain(ones),), results,
                 "probes")
    results["carry_scan"]["library_ms"] = cuda_ms(
        lambda: torch.cumsum(ones, 0, dtype=torch.int32), "torch.cumsum")
    bound(results, "carry_scan", 8 * n, n)
    del ones
    rnd = full_range(n, 6, dev)
    got = check_kernel("carry_scan[full range]",
                       lambda: (carry_scan.carry_scan(rnd),),
                       lambda: (carry_scan.carry_scan_plain(rnd),), None,
                       "probes")
    ms_a_byte = 1e3 / hbm_bytes_per_s()
    scan = results["carry_scan"]
    say("probes", f"carry_scan {n} rows: ones {scan['ms']:.3f} ms, full "
        f"range {got['ms']:.3f} ms; bound {8 * n * ms_a_byte:.3f} ms at 8 B "
        f"a row ({12 * n * ms_a_byte:.3f} at a three-pass scan's "
        f"12); torch.cumsum {scan['library_ms']:.3f} ms")
    del rnd

    n = bench_mat2.N // 4
    cols = {"ones": torch.ones(n, dtype=torch.int32, device=dev),
            "full range": full_range(n, 7, dev)}
    for rolls in bench_mat2.ROLLS:
        for what, col in cols.items():
            got = check_kernel(
                f"shift_loop[rolls={rolls}, {what}]",
                lambda: (shift_loop.shift_loop(col, rolls),),
                lambda: (shift_loop.shift_loop_plain(col, rolls),), None,
                "probes")
            if (rolls, what) == (20, "ones"):   # the line's entry
                results["shift_loop"].update(got)
        say("probes", f"shift_loop rolls={rolls}, {n} rows: {got['ms']:.3f} "
            f"ms; HBM bound {8 * n / hbm_bytes_per_s() * 1e3:.3f} ms, shared"
            f" memory {4 * rolls * n / 1e9:.3f} GB read")
    bound(results, "shift_loop", 8 * n, 20 * n)
    del cols

    for name, fn, path in (
            ("primitives", primitives.main, ("stream_scale", "smem_gather")),
            ("bench_mat2", bench_mat2.main,
             ("carry_scan", "shift_loop", "expand_runs", "expand_groups"))):
        t0 = time.perf_counter()
        rc, launches = _counted(lambda fn=fn: fn([]), path, name)
        if rc != 0:
            raise AssertionError(f"{name}: exit {rc}")
        for kernel in path[:2]:
            results[kernel]["launches"] = launches[kernel]
        say("probes", f"{name} at full size: {time.perf_counter() - t0:.3f}"
            f" s; launches {launches}")
        torch.cuda.empty_cache()


MC_STRATEGIES = ("fat512", "fatc512", "fatc256", "fatc128", "diag128",
                 "quad256")
FILL_STEP = 32768            # the JAX kernel's default step


def variants_phase(dev, results: dict) -> None:
    """The four design-probe kernels against their plain versions on their
    programs' full-size inputs (exact), every strategy or variant, timed;
    then the four programs at full size, each kernel launched in its
    program's run."""
    runs = {}
    for workload, rows, key_max in count_variants.WORKLOADS:
        bk, pk = count_variants.sorted_keys(rows, key_max, dev)
        for strategy in MC_STRATEGIES:
            got = check_kernel(
                f"merge_count_v[{workload}, {strategy}]",
                lambda s=strategy: slab_count.merge_count_v(bk, pk, s),
                lambda: slab_count.merge_count_v_plain(bk, pk), None,
                "variants")
            if workload == "ref_low":
                runs[strategy] = got
        if workload == "ref_low":    # the line's entry: the fastest
            best = min(runs, key=lambda k: runs[k]["ms"])
            results["merge_count_v"].update(runs[best])
            bound(results, "merge_count_v", 4 * rows + 12 * rows, 2 * rows)
            k2 = cuda_ms(lambda: merge_count.merge_count(bk, pk),
                         "merge_count")
            say("variants", f"ref_low {rows} x {rows}: fastest strategy "
                f"{best} {runs[best]['ms']:.3f} ms; K2 merge_count on the "
                f"same keys {k2:.3f} ms; bound "
                f"{results['merge_count_v']['bound_ms']:.3f} ms")
        del bk, pk
        torch.cuda.empty_cache()

    *state, cap = fill_variants.inputs(fill_variants.GROUPS, dev)
    nruns, ngroups, total = state[6:]
    runs = {}
    for variant in fill_phases.VARIANTS:
        runs[variant] = check_kernel(
            f"expand_fill_v[{variant}, step {FILL_STEP}]",
            lambda v=variant: fill_phases.expand_fill_v(*state, cap,
                                                        FILL_STEP, v),
            lambda v=variant: fill_phases.expand_fill_v_plain(
                *state, cap, FILL_STEP, v), None, "variants")
    results["expand_fill_v"].update(runs["full"])
    src_read = ngroups * fill_variants.NB
    bound(results, "expand_fill_v",
          8 * nruns + 12 * ngroups + 4 * src_read + 8 * cap, cap)
    say("variants", f"expand_fill_v {total} pairs, capacity {cap}: " + ", "
        .join(f"{v} {runs[v]['ms']:.3f}" for v in fill_phases.VARIANTS)
        + " ms")
    del state
    torch.cuda.empty_cache()

    *cols, nonzero, capacity = profile_expand_runs.inputs(
        profile_expand_runs.RUNS, dev)
    runs_phases.check_bases(cols[0], cols[3], cols[4], cols[5], nonzero,
                            capacity)
    runs = {}
    for variant in runs_phases.VARIANTS:
        runs[variant] = check_kernel(
            f"run_variant[{variant}]",
            lambda v=variant: runs_phases.run_variant(
                *cols, nonzero, capacity, capacity, v),
            lambda v=variant: runs_phases.run_variant_plain(
                *cols, nonzero, capacity, capacity, v), None, "variants")
    results["run_variant"].update(runs["full"])
    bound(results, "run_variant",
          12 * nonzero + 4 * cols[3].shape[0] + 8 * capacity, capacity)
    say("variants", f"run_variant {capacity} slots: " + ", ".join(
        f"{v} {runs[v]['ms']:.3f}" for v in runs_phases.VARIANTS) + " ms")
    del cols
    torch.cuda.empty_cache()

    offs_c, sid_c, total, nonzero, cap = probe_fill.compacted_runs(
        10_000_000, 100_000, dev)
    mark2d = forward_fill.scatter_markers(offs_c, sid_c, nonzero, cap)
    del offs_c, sid_c
    runs = {}
    for step in probe_fill.STEPS:
        runs[step] = check_kernel(
            f"fill_forward[step {step}]",
            lambda s=step: (forward_fill.fill_forward(mark2d, s),),
            lambda s=step: (forward_fill.fill_forward_plain(mark2d, s),),
            None, "variants")
    results["fill_forward"].update(runs[probe_fill.CHECK_STEP])
    bound(results, "fill_forward", 8 * cap, cap)
    del mark2d
    torch.cuda.empty_cache()

    for name, mod, kernel in (
            ("count_variants", count_variants, "merge_count_v"),
            ("fill_variants", fill_variants, "expand_fill_v"),
            ("profile_expand_runs", profile_expand_runs, "run_variant"),
            ("probe_fill", probe_fill, "fill_forward")):
        t0 = time.perf_counter()
        rc, launches = _counted(lambda mod=mod: mod.main([]), (kernel,), name)
        if rc != 0:
            raise AssertionError(f"{name}: exit {rc}")
        results[kernel]["launches"] = launches[kernel]
        say("variants", f"{name} at full size: "
            f"{time.perf_counter() - t0:.3f} s; {launches[kernel]} "
            f"{kernel} launches")
        torch.cuda.empty_cache()


FOLD_RATIO = 1.5             # least time ratio when ops or steps double
CHAIN_ENTRY = ("roll_sub", 256)


def chain_entry(dev, results: dict) -> None:
    """op_chain's kernels-line entry beside what it is compared with: the
    plain version timed over the kernel's ``steps`` repetitions, the one
    PyTorch call that gives the same tile (torch.roll by the composed
    shift, which skips the chain the probe times), and the op bound at the
    rate of the one SM the chain runs on."""
    kind, rows = CHAIN_ENTRY
    sh, ops, steps = roll_cost.SH, op_chain.OPS, op_chain.STEPS
    x = full_range(rows * op_chain.LANES, 8 + rows, dev).view(rows, -1)

    def library():
        return roll_cost.closed_form(x, sh, kind, ops)

    if max_abs_err((op_chain.op_chain(x, sh, kind),), (library(),)):
        raise AssertionError(f"op_chain {kind} R={rows}: not torch.roll by "
                             f"the composed shift")
    r = results["op_chain"]
    r["plain_ms"] = cuda_ms(
        lambda: [op_chain.op_chain_plain(x, sh, kind) for _ in range(steps)],
        f"op_chain plain x{steps}")
    r["library_ms"] = cuda_ms(library, "torch.roll by the composed shift")
    bound(results, "op_chain", 8 * rows * op_chain.LANES,
          ops * steps * rows * op_chain.LANES, sms=1)
    say("costs", f"op_chain {kind} R={rows}: plain over {steps} repetitions "
        f"{r['plain_ms']:.3f} ms; torch.roll by the composed shift "
        f"{r['library_ms']:.3f} ms; bound at one SM {r['bound_ms']:.3f} ms")


def costs_phase(dev, results: dict) -> None:
    """The three cost-probe kernels against their plain versions at their
    programs' full sizes (exact), timed, with op_chain's folding guard;
    then the three programs at full size, each kernel launched in its
    program's run."""
    sh, ops, steps = roll_cost.SH, op_chain.OPS, op_chain.STEPS
    for rows in roll_cost.PROGRAM_ROWS:
        x = full_range(rows * op_chain.LANES, 8 + rows, dev).view(rows, -1)
        for kind in op_chain.KINDS:
            got = check_kernel(
                f"op_chain[{kind}, R={rows}]",
                lambda k=kind: (op_chain.op_chain(x, sh, k),),
                lambda k=kind: (op_chain.op_chain_plain(x, sh, k),), None,
                "costs")
            if (kind, rows) == CHAIN_ENTRY:
                results["op_chain"].update(got)
            line = (f"op_chain {kind} R={rows}: "
                    f"{got['ms'] * 1e6 / (ops * steps):.1f} ns/op")
            if kind in op_chain.ROW_KINDS and rows <= 64:
                if max_abs_err((op_chain.op_chain(x, sh, kind, 5),),
                               (op_chain.op_chain_plain(x, sh, kind, 5),)):
                    raise AssertionError(f"op_chain {kind} R={rows}: "
                                         f"differs at 5 ops")
                line += "; exact at 5 ops"
            if rows in (16, 512):
                # 128 ops against 64, not 64 against 32: a repetition's
                # fixed cost weighs less beside the longer chain
                t_ops = cuda_ms(lambda k=kind: op_chain.op_chain(
                    x, sh, k, 2 * ops), f"op_chain {kind} twice the ops")
                t_steps = cuda_ms(lambda k=kind: op_chain.op_chain(
                    x, sh, k, ops, steps // 2), f"op_chain {kind} half steps")
                r_ops, r_steps = t_ops / got["ms"], got["ms"] / t_steps
                line += (f"; x{r_ops:.3f} for twice the ops, "
                         f"x{r_steps:.3f} for twice the repetitions")
                if r_ops < FOLD_RATIO or r_steps < FOLD_RATIO:
                    raise AssertionError(
                        f"op_chain {kind} R={rows}: folded or hoisted, "
                        f"x{r_ops:.3f} for twice the ops and x{r_steps:.3f} "
                        f"for twice the repetitions (< {FOLD_RATIO})")
            say("costs", line)
    chain_entry(dev, results)

    n = probe_opcost.N
    x = full_range(n, 9, dev)
    for rows in probe_opcost.BLOCK_ROWS:
        for ops in probe_opcost.OPS:
            shifts = torch.arange(1, ops + 1, dtype=torch.int32,
                                  device=dev) * probe_opcost.SHIFT
            got = check_kernel(
                f"select_chain[R={rows}, ops={ops}]",
                lambda s=shifts, o=ops, r=rows: (
                    select_chain.select_chain(x, s, o, r),),
                lambda s=shifts, o=ops, r=rows: (
                    select_chain.select_chain_plain(x, s, o, r),), None,
                "costs")
            if (rows, ops) == (128, 33):
                results["select_chain"].update(got)
    bound(results, "select_chain", 8 * n, 3 * 33 * n)

    n = probe_flatroll.N
    for rolls in probe_flatroll.ROLLS:
        shifts = torch.arange(1, rolls + 1, dtype=torch.int32,
                              device=dev) * probe_flatroll.SHIFT
        got = check_kernel(
            f"flat_roll[rolls={rolls}]",
            lambda s=shifts, r=rolls: (flat_roll.flat_roll(x, s, r),),
            lambda s=shifts, r=rolls: (flat_roll.flat_roll_plain(x, s, r),),
            None, "costs")
        if rolls == 20:
            results["flat_roll"].update(got)
    bound(results, "flat_roll", 8 * n, 20 * n)
    edge = torch.tensor([0, 1, 127, 128, 1023, 1024, 1500, -1, -130, IMAX],
                        dtype=torch.int32, device=dev)
    small = x[:1 << 20]
    for ks in [edge[k:k + 1] for k in range(edge.shape[0])] + [edge]:
        if max_abs_err((flat_roll.flat_roll(small, ks, ks.shape[0]),),
                       (flat_roll.flat_roll_plain(small, ks, ks.shape[0]),)):
            raise AssertionError(f"flat_roll differs at shifts {ks.tolist()}")
    say("costs", f"flat_roll exact at shifts {edge.tolist()}, each and "
        f"summed")
    del x, small
    torch.cuda.empty_cache()

    for name, mod, kernel in (
            ("roll_cost", roll_cost, "op_chain"),
            ("probe_opcost", probe_opcost, "select_chain"),
            ("probe_flatroll", probe_flatroll, "flat_roll")):
        t0 = time.perf_counter()
        rc, launches = _counted(lambda mod=mod: mod.main([]), (kernel,), name)
        if rc != 0:
            raise AssertionError(f"{name}: exit {rc}")
        results[kernel]["launches"] = launches[kernel]
        say("costs", f"{name} at full size: "
            f"{time.perf_counter() - t0:.3f} s; {launches[kernel]} "
            f"{kernel} launches")
        torch.cuda.empty_cache()


# capability-probe kernel -> (its module, its program, the words of data it
# reads at its program's input beside its scalars: one where it reads one)
MOSAIC = {"roll": (mosaic, probe_mosaic, mosaic.ROW),
          "smem_dyn": (mosaic, probe_mosaic, 0),
          "vmem_dyn": (mosaic, probe_mosaic, 1),
          "fori": (mosaic, probe_mosaic, mosaic.LANES),
          "smem_block": (mosaic, probe_mosaic, 1),
          "hbm_to_smem": (mosaic2, probe_mosaic2, 1),
          "dyn_vec_load": (mosaic2, probe_mosaic2, mosaic2.DV_OUT),
          "sublane_roll": (mosaic3, probe_mosaic3, 32 * mosaic3.LANES),
          "row_dma_2d": (mosaic3, probe_mosaic3, 32 * mosaic3.LANES),
          "flat_rotate": (mosaic3, probe_mosaic3, 8 * mosaic3.LANES)}


# the one-block kernels timed three times each in turns with their library
# call, the closest races of the kernels line
TURNS = ("row_dma_2d", "sublane_roll", "dyn_vec_load")


def mosaic_library(name: str, args: tuple):
    """The one PyTorch call that computes ``name``'s function at its
    program's input, and what it is, or None. A roll or a slice takes its
    shift or start as a host int (the program's), where the kernel reads
    it on the device; the flat rotate's torch.roll rolls the whole flat
    tile and keeps its first 1024 words (a view)."""
    x, s = args[0], args[-1]
    k = int(s[0])
    calls = {
        "roll": (lambda: torch.roll(x, -k, 1), f"torch.roll by {-k}"),
        "smem_dyn": (lambda: torch.index_select(
            s, 0, s[:1].expand(mosaic.LANES)).view(1, -1),
            "torch.index_select at s[0]"),
        "vmem_dyn": (lambda: torch.index_select(
            x.view(-1), 0, s.expand(mosaic.LANES)).view(1, -1),
            "torch.index_select at s[0]"),
        "dyn_vec_load": (lambda: torch.narrow_copy(x, 1, k, mosaic2.DV_OUT),
                         f"torch.narrow_copy at {k}"),
        "sublane_roll": (lambda: torch.roll(x, -k, 0), f"torch.roll by {-k}"),
        "row_dma_2d": (lambda: torch.narrow_copy(x, 0, k, mosaic3.RD_ROWS),
                       f"torch.narrow_copy at {k}"),
        "flat_rotate": (lambda: torch.roll(x.view(-1), -k)[
            :mosaic3.FR_OUT_ROWS * mosaic3.LANES].view(-1, mosaic3.LANES),
            f"torch.roll of the flat tile by {-k}"),
    }
    return calls.get(name)


def host_us(fn, reps: int = 2000) -> float:
    """Host microseconds a call of ``fn``, over ``reps`` calls that the
    device keeps up with (no sync between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def mosaic_phase(dev, results: dict) -> None:
    """The ten capability-probe kernels against their plain versions at
    their programs' inputs (exact), timed, with the library call beside
    those that have one (checked equal first), and at their programs' EDGES
    scalars on full-range data; row_dma_2d and its library call three
    times each, in turns; the host's cost a call of the TMA copy against
    two kernels without one; then the three programs, each kernel
    launched in its program's run."""
    for name, (mod, program, words) in MOSAIC.items():
        fn, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
        args = program.inputs(dev)[name]
        check_kernel(name, lambda: (fn(*args),), lambda: (plain(*args),),
                     results, "mosaic")
        out = fn(*args)
        ops = 2 * int(args[-1][0]) * out.numel() if name == "fori" else 0
        bound(results, name, 4 * (args[-1].numel() + words + out.numel()),
              ops)
        library = mosaic_library(name, args)
        line = f"{name}: bound {results[name]['bound_ms']:.3e} ms"
        if library is not None:
            call, what = library
            if max_abs_err((out,), (call(),)):
                raise AssertionError(f"{name}: {what} differs")
            results[name]["library_ms"] = cuda_ms(call, what)
            line += (f"; {what} {results[name]['library_ms']:.3f} ms, "
                     f"equal")
        edges = program.EDGES[name]
        for k, edge in enumerate(edges):
            eargs = [full_range(t.numel(), 20 + k, dev).view(t.shape)
                     for t in args[:-1]]
            eargs.append(torch.tensor(edge, dtype=torch.int32, device=dev))
            if max_abs_err((fn(*eargs),), (plain(*eargs),)):
                raise AssertionError(f"{name} differs from plain at {edge}")
        say("mosaic", f"{line}; exact at {len(edges)} edge inputs")

    for name in TURNS:
        mod, program, _ = MOSAIC[name]
        args = program.inputs(dev)[name]
        call, what = mosaic_library(name, args)
        turns = {"kernel": [], "library": []}
        for who in ("kernel", "library", "library", "kernel", "kernel",
                    "library"):
            fn = ((lambda: getattr(mod, name)(*args)) if who == "kernel"
                  else call)
            turns[who].append(cuda_ms(fn, f"{name} {who}"))
        say("mosaic", f"{name} in turns with {what}: kernel " + ", ".join(
            f"{ms:.6f}" for ms in turns["kernel"]) + " ms; library " + ", "
            .join(f"{ms:.6f}" for ms in turns["library"]) + " ms")

    costs = {name: host_us(lambda name=name, mod=MOSAIC[name][0], program=(
        MOSAIC[name][1].inputs(dev)[name]): getattr(mod, name)(*program))
        for name in ("row_dma_2d", "hbm_to_smem", "sublane_roll")}
    say("mosaic", "host us a call (wrapper and launch): " + ", ".join(
        f"{name} {us:.3f}" for name, us in costs.items()) + "; hbm_to_smem "
        "alone is a TMA copy")

    for name, mod in (("probe_mosaic", probe_mosaic),
                      ("probe_mosaic2", probe_mosaic2),
                      ("probe_mosaic3", probe_mosaic3)):
        path = tuple(k for k, v in MOSAIC.items() if v[1] is mod)
        t0 = time.perf_counter()
        rc, launches = _counted(lambda mod=mod: mod.main([]), path, name)
        if rc != 0:
            raise AssertionError(f"{name}: exit {rc}")
        for kernel in path:
            results[kernel]["launches"] = launches[kernel]
        say("mosaic", f"{name} at full size: {time.perf_counter() - t0:.3f}"
            f" s; launches " + ", ".join(f"{k} {launches[k]}" for k in path))
        torch.cuda.empty_cache()


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
                    help="row-count scale of the kernels phase's "
                         "low-selectivity keys, the matrix and the "
                         "semi/anti/outer split")
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
    say("device", f"HBM peak {hbm_bytes_per_s() / 1e9:.0f} GB/s "
        f"(tpujoin_torch/utils/hw.py)")

    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    say("build", f"{time.perf_counter() - t0:.3f} s")

    src = "tpujoin_torch/csrc/"
    results = {
        **{name: {"source": src + "radix_sort.cu",
                  "replaces": "tpujoin/kernels/merge_sort.py:389, "
                              "tpujoin/kernels/merge_sort.py:307"}
           for name in ("sort_histogram", "sort_pass")},
        "merge_count": {"source": src + "merge_count.cu",
                        "replaces": "tpujoin/kernels/merge_count.py:201, "
                                    "tpujoin/kernels/merge_count.py:218"},
        "compact3": {"source": src + "compact.cu",
                     "replaces": "tpujoin/kernels/compact.py:217"},
        "expand": {"source": src + "expand_pairs.cu",
                   "replaces": "tpujoin/kernels/expand.py:164"},
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
        "stream_scale": {"source": src + "primitives.cu",
                         "replaces": "bench/primitives.py:132"},
        "smem_gather": {"source": src + "primitives.cu",
                        "replaces": "bench/primitives.py:100"},
        "carry_scan": {"source": src + "bench_mat2.cu",
                       "replaces": "exp/bench_mat2.py:60"},
        "shift_loop": {"source": src + "bench_mat2.cu",
                       "replaces": "exp/bench_mat2.py:94"},
        "merge_count_v": {"source": src + "count_variants.cu",
                          "replaces": "exp/count_variants.py:156"},
        "expand_fill_v": {"source": src + "expand_pairs.cu",
                          "replaces": "exp/fill_variants.py:251"},
        "run_variant": {"source": src + "profile_expand_runs.cu",
                        "replaces": "exp/profile_expand_runs.py:126"},
        "fill_forward": {"source": src + "probe_fill.cu",
                         "replaces": "exp/probe_fill.py:64"},
        "op_chain": {"source": src + "roll_cost.cu",
                     "replaces": "exp/roll_cost.py:53"},
        "select_chain": {"source": src + "probe_opcost.cu",
                         "replaces": "exp/probe_opcost.py:39"},
        "flat_roll": {"source": src + "probe_flatroll.cu",
                      "replaces": "exp/probe_flatroll.py:61"},
        **{name: {"source": src + f"{file}.cu", "replaces": f"exp/{file}.py:"
                  f"{line}"} for name, file, line in (
            ("roll", "probe_mosaic", 43), ("smem_dyn", "probe_mosaic", 62),
            ("vmem_dyn", "probe_mosaic", 80), ("fori", "probe_mosaic", 104),
            ("smem_block", "probe_mosaic", 122),
            ("hbm_to_smem", "probe_mosaic2", 33),
            ("dyn_vec_load", "probe_mosaic2", 54),
            ("sublane_roll", "probe_mosaic3", 33),
            ("row_dma_2d", "probe_mosaic3", 55),
            ("flat_rotate", "probe_mosaic3", 86))},
    }
    low = bench.scaled_config("ref_low_selectivity", args.scale)
    high = bench.scaled_config("ref_high_selectivity")
    phases = (
        lambda: kernels_phase(dev, low, results),
        lambda: dense_kernels_phase(dev, high, results),
        lambda: runs_phase(dev, results),
        lambda: matrix_phase(dev, results, args.scale),
        lambda: v1_phase(dev, results),
        lambda: split_phase(dev, args.scale),
        lambda: tables_phase(dev),
        lambda: k6_phase(dev, results),
        lambda: ops_phase(dev, results),
        lambda: probes_phase(dev, results),
        lambda: variants_phase(dev, results),
        lambda: costs_phase(dev, results),
        lambda: mosaic_phase(dev, results),
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
