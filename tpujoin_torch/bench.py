"""Benchmark of the port: the equi-join phase by phase on both engines, the
multi-column join, and the filter, aggregate and sort operators (the port
of ``bench.py``).

With no ``--config`` it runs the JAX bench's default matrix: v2 on both
reference configs, v1 on ``ref_low_selectivity``, v1's factorized result on
``ref_high_selectivity``, v2 on ``zipf_skew``, then the multi-column join
with filter pushdown (BASELINE.json config 2). After every entry it prints
one summary line on stdout, ``hash_join_probe_rows_per_sec`` with a
``configs`` map, so the last stdout line is always the summary of the
entries that finished, also when SIGTERM or SIGALRM ends the run early.
Per-phase detail goes to stderr. ``--engine`` runs one engine on both
reference configs (v1 with its chunked dense materialization), ``--config``
one config; ``--op`` runs another operator and prints its
``<op>_rows_per_sec`` line. Data is made on the card from fixed seeds;
each phase is timed as the minimum of synchronized runs after a warm-up.

Every result is verified unless ``--no-verify``: join pairs against the
native oracle as an exact multiset; a dense config's factorized result
against the native RLE oracle and every materialized slot against that
verified form by window checksums (v2) or every pair by the multiset
checksum (v1, whose pairs come in probe order); the multi-column join's
pairs by their keys and its size by a count on the card; the filter's ids
and count against numpy; the aggregate's groups against the native group
count and its sums, mins and maxs against a numpy recompute.

Usage: python -m tpujoin_torch.bench [--config NAME] [--engine {v1,v2}]
                                     [--no-verify] [--scale F] [--budget S]
       python -m tpujoin_torch.bench --op {filter,aggregate,sort,multi_join}
                                     [--rows N] [--no-verify]

It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time

import numpy as np
import torch

from tpujoin_torch import oracle
from tpujoin_torch.core.config import PRESETS, JoinConfig
from tpujoin_torch.core.datagen import generator, make_keys
from tpujoin_torch.core.table import Table
from tpujoin_torch.ops import aggregate as agg
from tpujoin_torch.ops import filter as flt
from tpujoin_torch.ops import hash_join as hj
from tpujoin_torch.ops import multi_join as mjn
from tpujoin_torch.ops.hash_join import build
from tpujoin_torch.ops.merge_join import (capacities, plan_materialize,
                                          probe_count, probe_materialize,
                                          probe_rle)
from tpujoin_torch.ops.sort import sort_with_ids
from tpujoin_torch.utils import verify as vf
from tpujoin_torch.utils.hw import hbm_peak_gbps
from tpujoin_torch.utils.shapes import round_up
from tpujoin_torch.utils.timing import sync, time_fn

DENSE_MATCHES = 2.5e8   # above this, bench.py takes its RLE/fill path
# the most pairs bench_join_dense materializes (two i32 columns, 10 GB);
# above it the factorized result alone is the join
MAX_MATERIALIZED = (1 << 30) + (1 << 28)
OP_ROWS = 100_000_000   # rows of --op filter/aggregate/sort, as bench.py
FILTER_THRESHOLD = 80.0   # the reference's predicate, selection.mlir:61
V1_CHUNKS = 4              # probe chunks of v1's dense materialization
V1_CAP_BUCKET = 1 << 28    # its capacity step, slots
MULTI_JOIN_ROWS = 100_000_000   # rows a side of the matrix's multi-join

# The reference's own published figures (its join-performances.md, as
# BASELINE.md cites it), taken on an NVIDIA GPU whose model it does not
# name: neither a TPU nor an H100 number. Its probe rate on the
# low-selectivity config (1e8 probe rows in ~12 s), and its seconds for
# the materialized high-selectivity result, each engine against its own.
REFERENCE_PROBE_ROWS_PER_SEC = 8.3e6
_HIGH_BAR = {"v1": 2.0, "v1-rle": 2.0, "v2": 1.5, "v2-rle": 1.5}

# the default matrix: (config, engine, key in the summary's configs)
MATRIX = (("ref_low_selectivity", "v2", "ref_low_selectivity"),
          ("ref_high_selectivity", "v2", "ref_high_selectivity"),
          ("ref_low_selectivity", "v1", "ref_low_selectivity[v1]"),
          ("ref_high_selectivity", "v1-rle", "ref_high_selectivity[v1-rle]"),
          ("zipf_skew", "v2", "zipf_skew"))

# JoinConfig -> {"total", "msum"} of its oracle-verified pair multiset, so
# that the v1 dense entry checks its pairs against the expectation the v2
# dense entry already derived (a host expansion of ~1e9 pairs)
_RLE_CACHE: dict = {}


def eprint(*a):
    print(*a, file=sys.stderr, flush=True)


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def config_keys(cfg: JoinConfig, device: torch.device):
    """The build and probe keys of ``cfg``, made on ``device`` from its
    seed."""
    gen = generator(cfg.seed, device)
    bk = make_keys(gen, cfg.build_rows, cfg.key_min, cfg.key_max,
                   cfg.distribution, cfg.zipf_s)
    pk = make_keys(gen, cfg.probe_rows, cfg.key_min, cfg.key_max,
                   cfg.distribution, cfg.zipf_s)
    sync(device)
    return bk, pk


def _verify_dense(bk, pk, ht, state, k_cap: int, nonzero: int, mat,
                  total: int, all_matched: bool, cfg: JoinConfig) -> bool:
    """Parity gate for ~1e9-pair results: the native RLE oracle on the
    whole factorized result, then window checksums of every materialized
    slot against that verified form, so every pair is checked. A verified
    form's multiset sum goes into the cache under ``cfg``."""
    sid, lo, cnt = (c[:nonzero].cpu().numpy() for c in
                    probe_rle(state, k_cap, all_matched))
    src = ht.sorted_ids.cpu().numpy()
    rle_ok = oracle.check_join_rle(bk, pk, src, sid, lo, cnt) == 1
    eprint(f"RLE oracle parity: {'PASS' if rle_ok else 'FAIL'}")

    r_ids, s_ids, _ = mat()
    num_windows = r_ids.shape[0] // vf.VERIFY_WINDOW
    got_hi, got_lo = vf.window_checksums(r_ids, s_ids, total, num_windows)
    del r_ids, s_ids
    exp_hi, exp_lo, msum = vf.expected_checksums(src, sid, lo, cnt, total,
                                                 num_windows)
    if rle_ok:
        _RLE_CACHE[cfg] = {"total": total, "msum": msum}
    bad = int((got_hi != exp_hi).sum() + (got_lo != exp_lo).sum())
    eprint(f"materialized full-coverage parity ({num_windows} windows, "
           f"{total} pairs checked): {'PASS' if bad == 0 else 'FAIL'}"
           + ("" if bad == 0 else f" ({bad} window mismatches)"))
    return rle_ok and bad == 0


def bench_join_dense(cfg: JoinConfig, verify: bool,
                     device: torch.device | str = "cuda") -> dict:
    """High-selectivity configs (e.g. the reference's 10M x 10M, ~1e9-pair
    join): time the factorized (RLE) result, the engine's exact form, and
    the materialization of every pair on the path plan_materialize picks.
    Pairs are materialized only up to MAX_MATERIALIZED; above it the RLE
    result alone is timed and checked."""
    device = torch.device(device)
    bk, pk = config_keys(cfg, device)

    build_stat = time_fn(build, bk, device=device, name="build",
                         rows=cfg.build_rows)
    ht = build(bk)
    count_stat = time_fn(probe_count, ht, pk, device=device, name="count",
                         rows=cfg.probe_rows)
    state, total_t, nonzero_t = probe_count(ht, pk)
    total, nonzero = int(total_t), int(nonzero_t)
    k_cap = round_up(nonzero, 1 << 20)
    all_matched = nonzero == cfg.probe_rows
    eprint(f"rle compaction: {'identity' if all_matched else 'compact3'}")
    rle_stat = time_fn(lambda: probe_rle(state, k_cap, all_matched),
                       device=device, name="rle_result", rows=nonzero)

    materializable = total <= MAX_MATERIALIZED
    mat_stat = kernel = mat = None
    if materializable:
        cap = round_up(total, 1 << 20)
        kernel, plan_res, mat = plan_materialize(ht, state, k_cap, cap,
                                                 total=total, nonzero=nonzero)
        # free the plan's columns before the timed replays: at 1e9 pairs
        # each (r_ids, s_ids) set is 8 GB
        del plan_res
        mat_stat = time_fn(mat, device=device,
                           name=f"materialize_pairs[{kernel}]", rows=total,
                           bytes_touched=cap * 8)
    for st in (build_stat, count_stat, rle_stat, mat_stat):
        if st is not None:
            eprint(json.dumps(st.as_dict()))

    verified = pairs_checked = None
    if verify:
        if materializable:
            verified = _verify_dense(bk, pk, ht, state, k_cap, nonzero, mat,
                                     total, all_matched, cfg)
            pairs_checked = total if verified else 0
        else:
            sid, lo, cnt = (c[:nonzero].cpu().numpy() for c in
                            probe_rle(state, k_cap, all_matched))
            verified = oracle.check_join_rle(
                bk, pk, ht.sorted_ids, sid, lo, cnt) == 1
            eprint(f"RLE oracle parity: {'PASS' if verified else 'FAIL'}")

    probe_seconds = count_stat.seconds + rle_stat.seconds
    out = {
        "engine": "v2-rle",
        "config": cfg.name,
        "device": _device_name(device),
        "build_rows": cfg.build_rows,
        "probe_rows": cfg.probe_rows,
        "result_rows": total,
        "build_seconds": build_stat.seconds,
        "count_seconds": count_stat.seconds,
        "materialize_seconds": rle_stat.seconds,
        "total_seconds": build_stat.seconds + probe_seconds,
        "probe_rows_per_sec": cfg.probe_rows / probe_seconds,
        "hbm_peak_gbps": hbm_peak_gbps(device),
        "verified": verified,
    }
    if mat_stat is not None:
        out.update({
            "pair_kernel": kernel,
            "pair_expansion_rows_per_sec": total / mat_stat.seconds,
            "pair_materialize_seconds": mat_stat.seconds,
            "total_seconds_materialized": (build_stat.seconds
                                           + count_stat.seconds
                                           + mat_stat.seconds),
        })
        if pairs_checked is not None:
            out["pairs_checked"] = pairs_checked
    return out


def scaled_config(name: str, scale: float = 1.0) -> JoinConfig:
    """Preset ``name`` with both row counts multiplied by ``scale``."""
    cfg = PRESETS[name]
    if scale == 1.0:
        return cfg
    return dataclasses.replace(cfg, build_rows=int(cfg.build_rows * scale),
                               probe_rows=int(cfg.probe_rows * scale))


def _rle_expectation(cfg: JoinConfig, bk, pk) -> dict:
    """{total, msum} of ``cfg``'s pair multiset, from its v2 RLE form
    verified by the native RLE oracle; cached per config, so it is derived
    once when the v2 dense entry ran first."""
    if cfg in _RLE_CACHE:
        return _RLE_CACHE[cfg]
    ht = build(bk)
    state, total_t, nonzero_t = probe_count(ht, pk)
    total, nonzero = int(total_t), int(nonzero_t)
    sid, lo, cnt = (c[:nonzero].cpu().numpy() for c in
                    probe_rle(state, round_up(nonzero, 1 << 20)))
    src = ht.sorted_ids.cpu().numpy()
    if oracle.check_join_rle(bk, pk, src, sid, lo, cnt) != 1:
        raise RuntimeError("RLE oracle failed while building the "
                           "expectation")
    nw = -(-total // vf.VERIFY_WINDOW)
    _, _, msum = vf.expected_checksums(src, sid, lo, cnt, total, nw)
    _RLE_CACHE[cfg] = {"total": total, "msum": msum}
    return _RLE_CACHE[cfg]


def _v1_rle(cfg: JoinConfig, bk, pk, ht, verify: bool, device):
    """v1's factorized result, the count phase's (lo, counts) in probe
    order: its time over the whole probe side, its size and, with
    ``verify``, the native RLE oracle's verdict."""
    stat = time_fn(hj.probe_count, ht, pk, device=device, name="v1_rle",
                   rows=cfg.probe_rows)
    lo, cnt = hj.probe_count(ht, pk)
    total = int(cnt.sum(dtype=torch.int64))
    verified = None
    if verify:
        verified = oracle.check_join_rle(
            bk, pk, ht.sorted_ids, np.arange(cfg.probe_rows, dtype=np.int32),
            lo, cnt) == 1
        eprint(f"v1 RLE oracle parity: {'PASS' if verified else 'FAIL'}")
    return stat, total, verified


def bench_join_dense_v1(cfg: JoinConfig, verify: bool,
                        num_chunks: int = V1_CHUNKS,
                        cap_bucket: int = V1_CAP_BUCKET,
                        rle_only: bool = False,
                        device: torch.device | str = "cuda") -> dict:
    """v1 on a high-selectivity config: the probe side in ``num_chunks``
    chunks, each materialized at its total rounded up to ``cap_bucket``
    (the dense path, on fill_forward), every pair verified by the multiset
    checksum against the config's verified RLE form; then v1's factorized
    result timed and checked by the RLE oracle. ``rle_only`` (the matrix's
    entry) runs the factorized result alone."""
    device = torch.device(device)
    bk, pk = config_keys(cfg, device)
    build_stat = time_fn(build, bk, device=device, name="build",
                         rows=cfg.build_rows, iters=1)
    ht = build(bk)
    out = {"engine": "v1-rle" if rle_only else "v1", "config": cfg.name,
           "device": _device_name(device), "build_rows": cfg.build_rows,
           "probe_rows": cfg.probe_rows}

    if rle_only:
        rle_stat, total, rle_verified = _v1_rle(cfg, bk, pk, ht, verify,
                                                device)
        seconds = build_stat.seconds + rle_stat.seconds
        out.update({
            "result_rows": total,
            "build_seconds": build_stat.seconds,
            "rle_result_seconds": rle_stat.seconds,
            "total_seconds": seconds,
            "total_seconds_rle": seconds,
            "probe_rows_per_sec": cfg.probe_rows / rle_stat.seconds,
            "rle_verified": rle_verified,
            "hbm_peak_gbps": hbm_peak_gbps(device),
            "verified": rle_verified,
        })
        return out

    chunk = cfg.probe_rows // num_chunks
    if chunk * num_chunks != cfg.probe_rows:
        raise ValueError(f"{cfg.probe_rows} probe rows in {num_chunks} "
                         f"chunks")
    count_secs = mat_secs = 0.0
    grand_total = acc = 0
    for ci in range(num_chunks):
        start = ci * chunk
        pk_c = pk[start:start + chunk]
        st = time_fn(hj.probe_count, ht, pk_c, device=device,
                     warmup=1 if ci == 0 else 0, iters=1,
                     name=f"count[{ci}]")
        count_secs += st.seconds
        lo, counts = hj.probe_count(ht, pk_c)
        total_c = int(counts.sum(dtype=torch.int64))
        grand_total += total_c
        cap_c = round_up(max(total_c, 1), cap_bucket)

        def mat(lo=lo, counts=counts, cap_c=cap_c, start=start):
            return hj.probe_materialize(ht, lo, counts, cap_c,
                                        probe_base=start)

        st2 = time_fn(mat, device=device, warmup=1 if ci == 0 else 0,
                      iters=1, name=f"materialize[{ci}]")
        mat_secs += st2.seconds
        if verify:
            r_c, s_c, t_c, fits = mat()
            if not bool(fits):
                raise RuntimeError("materialize capacity undersized")
            acc = (acc + vf.device_multiset_sum(r_c, s_c, int(t_c))) % (
                1 << 64)
            del r_c, s_c

    verified = None
    if verify:
        exp = _rle_expectation(cfg, bk, pk)
        verified = grand_total == exp["total"] and acc == exp["msum"]
        eprint(f"v1 multiset checksum over {grand_total} pairs "
               f"({num_chunks} chunks): {'PASS' if verified else 'FAIL'}")

    rle_stat, _, rle_verified = _v1_rle(cfg, bk, pk, ht, verify, device)
    total_seconds = build_stat.seconds + count_secs + mat_secs
    eprint(json.dumps({"phase": "v1_dense", "build": build_stat.seconds,
                       "count": count_secs, "materialize": mat_secs,
                       "chunks": num_chunks}))
    out.update({
        "result_rows": grand_total,
        "build_seconds": build_stat.seconds,
        "count_seconds": count_secs,
        "materialize_seconds": mat_secs,
        "total_seconds": total_seconds,
        "total_seconds_materialized": total_seconds,
        "probe_rows_per_sec": cfg.probe_rows / (count_secs + mat_secs),
        "probe_chunks": num_chunks,
        "rle_result_seconds": rle_stat.seconds,
        "total_seconds_rle": build_stat.seconds + rle_stat.seconds,
        "rle_verified": rle_verified,
        "hbm_peak_gbps": hbm_peak_gbps(device),
        "verified": verified,
    })
    if verified:
        out["pairs_checked"] = grand_total
    return out


def bench_join(cfg: JoinConfig, verify: bool, engine: str = "v2",
               device: torch.device | str = "cuda") -> dict:
    """Time build, count and materialize of ``cfg`` on ``device`` with
    ``engine`` (v2, the sort-merge join; v1, the searchsorted join; v1-rle,
    v1's factorized result); return the summary dict (``verified`` is None
    unless ``verify``). Configs whose expected result passes DENSE_MATCHES
    go to :func:`bench_join_dense` (v2) or :func:`bench_join_dense_v1`;
    below it v1-rle runs as v1."""
    if cfg.expected_matches > DENSE_MATCHES:
        if engine == "v2":
            return bench_join_dense(cfg, verify, device)
        return bench_join_dense_v1(cfg, verify, rle_only=engine == "v1-rle",
                                   device=device)
    v1 = engine.startswith("v1")
    device = torch.device(device)
    bk, pk = config_keys(cfg, device)

    build_stat = time_fn(build, bk, device=device, name="build",
                         rows=cfg.build_rows,
                         bytes_touched=cfg.build_rows * 4 * 4)
    ht = build(bk)
    if v1:
        count_stat = time_fn(hj.probe_count, ht, pk, device=device,
                             name="count", rows=cfg.probe_rows,
                             bytes_touched=(cfg.build_rows
                                            + cfg.probe_rows) * 4 * 4)
        lo, counts = hj.probe_count(ht, pk)
        total = int(counts.sum(dtype=torch.int64))
        cap = round_up(total, cfg.result_pad_multiple)
        mat_bytes = cfg.probe_rows * 8 + cap * 8 * 3

        def materialize():
            return hj.probe_materialize(ht, lo, counts, cap)
    else:
        count_stat = time_fn(probe_count, ht, pk, device=device,
                             name="count", rows=cfg.probe_rows,
                             bytes_touched=(cfg.build_rows
                                            + cfg.probe_rows * 3) * 4)
        state, total, nonzero = probe_count(ht, pk)
        total, nonzero = int(total), int(nonzero)
        k_cap, cap = capacities(total, nonzero, cfg.result_pad_multiple)
        mat_bytes = cfg.probe_rows * 12 + cap * 8 * 2

        def materialize():
            return probe_materialize(ht, state, k_cap, cap, total=total,
                                     nonzero=nonzero)
    mat_stat = time_fn(materialize, device=device, name="materialize",
                       rows=total, bytes_touched=mat_bytes)
    for st in (build_stat, count_stat, mat_stat):
        eprint(json.dumps(st.as_dict()))

    verified = None
    if verify:
        r_ids, s_ids, _, fits = materialize()
        if not bool(fits):
            raise RuntimeError("materialize capacity undersized")
        verified = oracle.check_join(bk, pk, r_ids[:total],
                                     s_ids[:total]) == 1
        eprint(f"oracle multiset parity: {'PASS' if verified else 'FAIL'}")

    probe_seconds = count_stat.seconds + mat_stat.seconds
    return {
        "engine": "v1" if v1 else engine,
        "config": cfg.name,
        "device": _device_name(device),
        "build_rows": cfg.build_rows,
        "probe_rows": cfg.probe_rows,
        "result_rows": total,
        "build_seconds": build_stat.seconds,
        "count_seconds": count_stat.seconds,
        "materialize_seconds": mat_stat.seconds,
        "total_seconds": build_stat.seconds + probe_seconds,
        "probe_rows_per_sec": cfg.probe_rows / probe_seconds,
        "hbm_peak_gbps": hbm_peak_gbps(device),
        "verified": verified,
    }


def _compaction(device: torch.device) -> str:
    """What compacts on ``device``: K6 on the card, the plain version on
    the CPU."""
    return "kernel" if device.type == "cuda" else "plain"


def filter_values(rows: int, device: torch.device) -> torch.Tensor:
    """The filter's column: f32 uniform in [0, 160) from seed 0, so the
    predicate keeps about half the rows."""
    return torch.rand(rows, generator=generator(0, device),
                      device=device) * 160.0


def filter_capacity(rows: int) -> int:
    """bench.py's output capacity: 5/8 of the rows, in 2^20 steps."""
    return round_up(rows // 2 + rows // 8, 1 << 20)


def bench_filter(rows: int, verify: bool,
                 device: torch.device | str = "cuda") -> dict:
    """Selection + stream compaction (the reference's selection.mlir
    workload): the ids of the rows with value < 80 at a fixed capacity."""
    device = torch.device(device)
    vals = filter_values(rows, device)
    sync(device)
    cap = filter_capacity(rows)

    def run():
        return flt.filter_device(vals, FILTER_THRESHOLD, cap)

    stat = time_fn(run, device=device, name="filter", rows=rows,
                   bytes_touched=rows * 12)
    eprint(json.dumps(stat.as_dict()))
    verified = None
    if verify:
        ids, total = run()
        total = int(total)
        v = vals.cpu().numpy()
        ids_np = ids[:total].cpu().numpy()
        verified = (total == int((v < FILTER_THRESHOLD).sum())
                    and len(ids_np) == total
                    and bool((v[ids_np] < FILTER_THRESHOLD).all())
                    and bool((np.diff(ids_np) > 0).all())
                    and bool((ids[total:] == -1).all()))
        eprint(f"filter parity: {'PASS' if verified else 'FAIL'}")
    return {"op": "filter", "rows": rows, "device": _device_name(device),
            "total_seconds": stat.seconds,
            "rows_per_sec": rows / stat.seconds,
            "compaction": _compaction(device), "verified": verified}


def aggregate_inputs(rows: int, key_max: int, device: torch.device):
    """The aggregate's keys, uniform in [1, key_max] from seed 0, and
    values, uniform in [0, 1e6] from seed 1."""
    keys = make_keys(generator(0, device), rows, 1, key_max)
    vals = make_keys(generator(1, device), rows, 0, 1_000_000)
    sync(device)
    return keys, vals


def _verify_aggregate(keys, vals, ngroups: int, counted, valued) -> bool:
    """The count path against the native group count, the value path
    against a numpy recompute (sums as exact int64)."""
    gk, gc, _ = counted
    k_np = keys.cpu().numpy()
    ok, oc = oracle.group_by_count(k_np)
    count_ok = (np.array_equal(gk[:ngroups].cpu().numpy(), ok)
                and np.array_equal(gc[:ngroups].cpu().numpy(), oc))
    eprint(f"aggregate oracle parity: {'PASS' if count_ok else 'FAIL'}")
    gk2, gc2, sums, gmin, gmax = (c[:ngroups].cpu().numpy()
                                  for c in valued[:5])
    v_np = vals.cpu().numpy().astype(np.int64)
    order = np.argsort(k_np, kind="stable")
    ks_np, vs_np = k_np[order], v_np[order]
    bnd = np.flatnonzero(np.r_[True, ks_np[1:] != ks_np[:-1]])
    ends = np.r_[bnd[1:], len(ks_np)]
    cs = np.r_[0, np.cumsum(vs_np)]
    values_ok = (np.array_equal(gk2, ks_np[bnd])
                 and np.array_equal(gc2, ends - bnd)
                 and np.array_equal(sums, cs[ends] - cs[bnd])
                 and np.array_equal(gmin.astype(np.int64),
                                    np.minimum.reduceat(vs_np, bnd))
                 and np.array_equal(gmax.astype(np.int64),
                                    np.maximum.reduceat(vs_np, bnd)))
    eprint(f"aggregate value-path parity: "
           f"{'PASS' if values_ok else 'FAIL'}")
    return count_ok and values_ok


def bench_aggregate(rows: int, key_max: int, verify: bool,
                    device: torch.device | str = "cuda") -> dict:
    """Hash aggregate (group-by count, then per-group count, sum, min and
    max), BASELINE.json config 3."""
    device = torch.device(device)
    keys, vals = aggregate_inputs(rows, key_max, device)
    count_stat = time_fn(agg.group_count, keys, device=device,
                         name="agg_count", rows=rows, bytes_touched=rows * 8)
    ngroups = int(agg.group_count(keys))
    cap = round_up(ngroups, 1 << 20)

    def counted():
        return agg.group_materialize(keys, cap)

    def valued():
        return agg.group_agg_materialize(keys, vals, cap)

    mat_stat = time_fn(counted, device=device, name="agg_materialize",
                       rows=rows, bytes_touched=rows * 12 + cap * 8)
    agg_stat = time_fn(valued, device=device, name="agg_values", rows=rows,
                       bytes_touched=rows * 16 + cap * 24)
    for st in (count_stat, mat_stat, agg_stat):
        eprint(json.dumps(st.as_dict()))
    verified = (_verify_aggregate(keys, vals, ngroups, counted(), valued())
                if verify else None)
    secs = count_stat.seconds + mat_stat.seconds
    return {"op": "aggregate", "rows": rows, "groups": ngroups,
            "device": _device_name(device), "total_seconds": secs,
            "rows_per_sec": rows / secs,
            "agg_values_seconds": agg_stat.seconds,
            "agg_values_rows_per_sec": rows / agg_stat.seconds,
            "compaction": _compaction(device), "verified": verified}


def bench_sort(rows: int, device: torch.device | str = "cuda") -> dict:
    """Key + id sort, the primitive under the build and probe phases
    (``sort_with_ids``: torch.sort, the counterpart of jax.lax.sort)."""
    device = torch.device(device)
    keys = make_keys(generator(0, device), rows, 1, 1 << 30)
    sync(device)
    stat = time_fn(sort_with_ids, keys, device=device, name="sort_keyval",
                   rows=rows, bytes_touched=rows * 16)
    eprint(json.dumps(stat.as_dict()))
    return {"op": "sort", "rows": rows, "device": _device_name(device),
            "total_seconds": stat.seconds,
            "rows_per_sec": rows / stat.seconds}


def run_op(op: str, rows: int, verify: bool,
           device: torch.device | str = "cuda") -> dict:
    """The ``--op`` other than join at ``rows`` rows, as bench.py sizes
    it (aggregate keys in [1, max(rows // 10, 100)])."""
    if op == "filter":
        return bench_filter(rows, verify, device)
    if op == "aggregate":
        return bench_aggregate(rows, max(rows // 10, 100), verify, device)
    if op == "sort":
        return bench_sort(rows, device)
    raise ValueError(f"unknown op {op!r}")


def multi_join_tables(rows: int, device: torch.device):
    """The multi-column join's two tables (BASELINE.json config 2 as
    bench.py builds it): keys k1 in [1, 1e5], k2 in [1, 1e4] and a value v
    in [0, 1000] a side, from seed 7 on ``device``."""
    gen = generator(7, device)

    def side():
        return Table({"k1": make_keys(gen, rows, 1, 100_000),
                      "k2": make_keys(gen, rows, 1, 10_000),
                      "v": make_keys(gen, rows, 0, 1000)})

    r, s = side(), side()
    sync(device)
    return r, s


def _multi_join_expected(r: Table, s: Table) -> int:
    """|R join S| on (k1, k2), counted on the device: the packed int64
    keys of R sorted, each S key's run found by two searchsorted."""
    def packed(t):
        return (t["k1"].long() << 32) | t["k2"].long()

    crs = torch.sort(packed(r)).values
    cs = packed(s)
    hi = torch.searchsorted(crs, cs, right=True)
    return int((hi - torch.searchsorted(crs, cs)).sum())


def bench_multi_join(rows: int, verify: bool,
                     device: torch.device | str = "cuda") -> dict:
    """Multi-column equi-join on (k1, k2), and the same join with the
    filter v < 500 pushed down on both sides (BASELINE.json config 2):
    each timed to its result on the device. Verified: every pair's keys
    equal, and the pair count equal to a count on the device."""
    device = torch.device(device)
    r, s = multi_join_tables(rows, device)
    on = ["k1", "k2"]

    def join():
        return mjn.hash_join_multi(r, s, on, return_numpy=False)

    def pushdown():
        return mjn.join_with_pushdown(
            r, s, on, r_pred=lambda v: v < 500, r_pred_col="v",
            s_pred=lambda v: v < 500, s_pred_col="v", return_numpy=False)

    st = time_fn(join, device=device, name="multi_join", rows=rows)
    out_r, out_s, total = join()
    stp = time_fn(pushdown, device=device, name="pushdown_join", rows=rows)
    _, _, push_rows = pushdown()
    eprint(json.dumps(st.as_dict()))
    eprint(json.dumps(stp.as_dict()))

    verified = None
    if verify:
        ri, si = out_r[:total].long(), out_s[:total].long()
        pair_ok = bool((r["k1"][ri] == s["k1"][si]).all()
                       and (r["k2"][ri] == s["k2"][si]).all())
        expected = _multi_join_expected(r, s)
        verified = pair_ok and expected == total
        eprint(f"multi-join parity: {'PASS' if verified else 'FAIL'} "
               f"(rows {total} expected {expected})")
    return {"op": "multi_join", "rows": rows, "device": _device_name(device),
            "result_rows": total, "join_seconds": st.seconds,
            "pushdown_seconds": stp.seconds,
            "pushdown_result_rows": push_rows, "total_seconds": st.seconds,
            "rows_per_sec": rows / st.seconds, "verified": verified}


# ---- the summary line ----
#
# One JSON line of the finished entries, the same bytes as bench.py's
# ``_summary_line`` for the same entries: floats at 5 significant digits,
# compact separators, and the reduced keys when the full line would pass
# 1900 bytes, so a reader of the output's last ~2000 bytes always parses
# it.

def _round5(x):
    if isinstance(x, float):
        return float(f"{x:.5g}")
    if isinstance(x, dict):
        return {k: _round5(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_round5(v) for v in x]
    return x


_CFG_KEYS = ("engine", "op", "result_rows", "build_seconds",
             "count_seconds", "materialize_seconds", "total_seconds",
             "probe_rows_per_sec", "rows_per_sec", "join_seconds",
             "pushdown_seconds", "pushdown_result_rows",
             "probe_chunks", "verified", "pairs_checked")
_CFG_KEYS_MIN = ("engine", "op", "result_rows", "total_seconds",
                 "total_seconds_materialized", "vs_ref_materialized",
                 "total_seconds_rle", "verified", "pairs_checked")


def _config_entry(c: dict, keys) -> dict:
    out = {k: c[k] for k in keys if k in c}
    if "pair_kernel" in c and "pair_kernel" not in out:
        out["pair_kernel"] = c["pair_kernel"]
        out["pair_materialize_seconds"] = c["pair_materialize_seconds"]
    if "total_seconds_materialized" in c:
        out["total_seconds_materialized"] = c["total_seconds_materialized"]
        out["vs_ref_materialized"] = (_HIGH_BAR.get(c.get("engine"), 1.5)
                                      / c["total_seconds_materialized"])
    if "total_seconds_rle" in c:
        out["total_seconds_rle"] = c["total_seconds_rle"]
        out["rle_verified"] = c["rle_verified"]
        out["vs_ref_rle"] = (_HIGH_BAR.get(c.get("engine"), 1.5)
                             / c["total_seconds_rle"])
        if keys is _CFG_KEYS:
            out["rle_result_seconds"] = c["rle_result_seconds"]
            out["ref_bar_is_materialized"] = True
    return out


def _summary_line(configs: dict, verify: bool) -> str:
    if not configs:
        return json.dumps({"metric": "hash_join_probe_rows_per_sec",
                           "value": 0.0, "unit": "rows/s",
                           "vs_baseline": 0.0, "configs": {}})
    head_key = ("ref_low_selectivity" if "ref_low_selectivity" in configs
                else next(iter(configs)))
    value = configs[head_key].get("probe_rows_per_sec",
                                  configs[head_key].get("rows_per_sec", 0.0))
    for keys in (_CFG_KEYS, _CFG_KEYS_MIN):
        line = json.dumps(_round5({
            "metric": "hash_join_probe_rows_per_sec",
            "value": value,
            "unit": "rows/s",
            "vs_baseline": value / REFERENCE_PROBE_ROWS_PER_SEC,
            "verified": all(c.get("verified") for c in configs.values())
            if verify else None,
            "configs": {n: _config_entry(c, keys)
                        for n, c in configs.items()},
        }), separators=(",", ":"))
        if len(line) <= 1900:
            break
    return line


def emit_summary(completed: dict, verify: bool) -> None:
    sys.stderr.flush()
    print(_summary_line(completed, verify), flush=True)


def summary_on_signal(completed: dict, verify: bool):
    """A SIGTERM/SIGALRM handler: print the summary of the entries in
    ``completed`` and end the process at once (exit 0, or 1 with none)."""
    def handler(signum, frame):
        eprint(f"bench: signal {signum} after {len(completed)} completed "
               f"configs, emitting the summary")
        if completed:
            emit_summary(completed, verify)
        os._exit(0 if completed else 1)

    return handler


def matrix_entries(config: str | None = None,
                   engine: str | None = None) -> list:
    """The (config, engine, key) entries of a run: one config; with an
    engine, that engine on both reference configs (and zipf_skew for v2);
    else the default MATRIX."""
    if config is not None:
        return [(config, engine or "v2", config)]
    if engine is not None:
        entries = [(name, engine, name) for name in
                   ("ref_low_selectivity", "ref_high_selectivity")]
        if engine == "v2":
            entries.append(("zipf_skew", "v2", "zipf_skew"))
        return entries
    return list(MATRIX)


def run_matrix(entries, completed: dict, *, verify: bool = True,
               scale: float = 1.0, budget: float = 0.0,
               multi_join: bool = False,
               device: torch.device | str = "cuda",
               clock=time.monotonic, run=None) -> dict:
    """Run ``entries`` in order, then with ``multi_join`` the multi-column
    join at MULTI_JOIN_ROWS * ``scale`` rows; record each entry's dict in
    ``completed`` under its key and print the summary line after each.
    Once ``budget`` seconds (0: none) have passed on ``clock``, the
    remaining entries are skipped. ``run(key, fn)`` runs one entry's
    ``fn`` (by default, just calls it)."""
    run = run or (lambda key, fn: fn())
    t_start = clock()

    def over_budget() -> bool:
        return bool(budget) and clock() - t_start > budget

    for name, engine, key in entries:
        if completed and over_budget():
            eprint(f"bench: soft budget {budget:.0f}s exceeded, skipping "
                   f"{key} and later entries")
            break
        cfg = scaled_config(name, scale)
        detail = run(key, lambda: bench_join(cfg, verify, engine, device))
        eprint(json.dumps(detail))
        completed[key] = detail
        emit_summary(completed, verify)
    if multi_join and not over_budget():
        detail = run("multi_join", lambda: bench_multi_join(
            int(MULTI_JOIN_ROWS * scale), verify, device))
        eprint(json.dumps(detail))
        completed["multi_join"] = detail
        emit_summary(completed, verify)
    return completed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", default="join",
                    choices=["join", "filter", "aggregate", "sort",
                             "multi_join"])
    ap.add_argument("--config", default=None, choices=sorted(PRESETS),
                    help="one config (default: the matrix)")
    ap.add_argument("--engine", default=None, choices=["v1", "v2"],
                    help="one engine on both reference configs")
    ap.add_argument("--verify", action="store_true", default=True,
                    help="check every result (the default; see the module "
                         "docstring)")
    ap.add_argument("--no-verify", dest="verify", action="store_false")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale factor of the join configs")
    ap.add_argument("--rows", type=int, default=OP_ROWS,
                    help="row count of --op filter/aggregate/sort/"
                         "multi_join")
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("TPUJOIN_BENCH_BUDGET",
                                                 1500.0)),
                    help="soft budget in seconds: later entries are "
                         "skipped once it is spent (0: none); a hard stop "
                         "600 s after it prints the summary")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        eprint("tpujoin_torch.bench: no CUDA device")
        return 1
    if args.op != "join":
        detail = (bench_multi_join(args.rows, args.verify)
                  if args.op == "multi_join"
                  else run_op(args.op, args.rows, args.verify))
        eprint(json.dumps(detail))
        print(json.dumps({"metric": f"{args.op}_rows_per_sec",
                          "value": detail["rows_per_sec"], "unit": "rows/s",
                          "vs_baseline": 1.0}), flush=True)
        return 0 if detail.get("verified") in (None, True) else 1

    completed: dict = {}
    handler = summary_on_signal(completed, args.verify)
    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGALRM, handler)
    if args.budget:
        signal.alarm(int(args.budget + 600))
    try:
        run_matrix(matrix_entries(args.config, args.engine), completed,
                   verify=args.verify, scale=args.scale, budget=args.budget,
                   multi_join=args.config is None and args.engine is None)
    finally:
        signal.alarm(0)
    return 0 if all(c.get("verified") in (None, True)
                    for c in completed.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
