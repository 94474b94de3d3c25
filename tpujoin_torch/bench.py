"""Benchmark of the port: the v2 sort-merge join phase by phase, and the
filter, aggregate and sort operators.

The port of ``bench.py:bench_join`` (its ``engine == "v2"`` branch), of
``bench_join_dense``, which it takes for the high-selectivity configs
(expected result above 2.5e8 pairs), and of ``bench_filter``,
``bench_aggregate`` and ``bench_sort`` (``--op``). Data is made on the card
from fixed seeds; each phase is timed as the minimum of three synchronized
runs after one warm-up. stdout is one JSON line with the same keys as the
JAX entry; per-phase detail goes to stderr. ``--verify`` checks every
result: join pairs against the native oracle as an exact multiset, or for a
dense config, the factorized (RLE) result against the native RLE oracle
and every materialized slot against that verified form by window
checksums; the filter's ids and count against numpy; the aggregate's
groups against the native group count and its sums, mins and maxs against
a numpy recompute, sums as exact int64.

Usage: python -m tpujoin_torch.bench [--op join] [--config NAME] [--verify]
                                     [--scale F]
       python -m tpujoin_torch.bench --op {filter,aggregate,sort}
                                     [--rows N] [--verify]

It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from tpujoin_torch import oracle
from tpujoin_torch.core.config import PRESETS, JoinConfig
from tpujoin_torch.core.datagen import make_keys
from tpujoin_torch.ops import aggregate as agg
from tpujoin_torch.ops import filter as flt
from tpujoin_torch.ops.hash_join import build
from tpujoin_torch.ops.merge_join import (plan_materialize, probe_count,
                                          probe_materialize, probe_rle)
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


def eprint(*a):
    print(*a, file=sys.stderr, flush=True)


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def config_keys(cfg: JoinConfig, device: torch.device):
    """The build and probe keys of ``cfg``, made on ``device`` from its
    seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    bk = make_keys(gen, cfg.build_rows, cfg.key_min, cfg.key_max,
                   cfg.distribution, cfg.zipf_s)
    pk = make_keys(gen, cfg.probe_rows, cfg.key_min, cfg.key_max,
                   cfg.distribution, cfg.zipf_s)
    sync(device)
    return bk, pk


def _verify_dense(bk, pk, ht, state, k_cap: int, nonzero: int, mat,
                  total: int, all_matched: bool) -> bool:
    """Parity gate for ~1e9-pair results: the native RLE oracle on the
    whole factorized result, then window checksums of every materialized
    slot against that verified form, so every pair is checked."""
    sid, lo, cnt = (c[:nonzero].cpu().numpy() for c in
                    probe_rle(state, k_cap, all_matched))
    src = ht.sorted_ids.cpu().numpy()
    rle_ok = oracle.check_join_rle(bk, pk, src, sid, lo, cnt) == 1
    eprint(f"RLE oracle parity: {'PASS' if rle_ok else 'FAIL'}")

    r_ids, s_ids, _ = mat()
    num_windows = r_ids.shape[0] // vf.VERIFY_WINDOW
    got_hi, got_lo = vf.window_checksums(r_ids, s_ids, total, num_windows)
    del r_ids, s_ids
    exp_hi, exp_lo, _ = vf.expected_checksums(src, sid, lo, cnt, total,
                                              num_windows)
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
                                     total, all_matched)
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


def bench_join(cfg: JoinConfig, verify: bool,
               device: torch.device | str = "cuda") -> dict:
    """Time build, count and materialize of ``cfg`` on ``device``; return
    the summary dict (``verified`` is None unless ``verify``). Configs
    whose expected result passes DENSE_MATCHES go to
    :func:`bench_join_dense`."""
    if cfg.expected_matches > DENSE_MATCHES:
        return bench_join_dense(cfg, verify, device)
    device = torch.device(device)
    bk, pk = config_keys(cfg, device)

    build_stat = time_fn(build, bk, device=device, name="build",
                         rows=cfg.build_rows,
                         bytes_touched=cfg.build_rows * 4 * 4)
    ht = build(bk)
    count_stat = time_fn(probe_count, ht, pk, device=device, name="count",
                         rows=cfg.probe_rows,
                         bytes_touched=(cfg.build_rows
                                        + cfg.probe_rows * 3) * 4)
    state, total_t, nonzero_t = probe_count(ht, pk)
    total, nonzero = int(total_t), int(nonzero_t)
    cap = round_up(total, cfg.result_pad_multiple)
    k_cap = round_up(nonzero, max(cfg.result_pad_multiple // 8, 1024))
    mat_stat = time_fn(lambda: probe_materialize(ht, state, k_cap, cap,
                                                 total=total_t,
                                                 nonzero=nonzero_t),
                       device=device, name="materialize", rows=total,
                       bytes_touched=cfg.probe_rows * 12 + cap * 8 * 2)
    for st in (build_stat, count_stat, mat_stat):
        eprint(json.dumps(st.as_dict()))

    verified = None
    if verify:
        r_ids, s_ids, _, fits = probe_materialize(
            ht, state, k_cap, cap, total=total_t, nonzero=nonzero_t)
        if not bool(fits):
            raise RuntimeError("materialize capacity undersized")
        verified = oracle.check_join(bk, pk, r_ids[:total],
                                     s_ids[:total]) == 1
        eprint(f"oracle multiset parity: {'PASS' if verified else 'FAIL'}")

    probe_seconds = count_stat.seconds + mat_stat.seconds
    return {
        "engine": "v2",
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


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _compaction(device: torch.device) -> str:
    """What compacts on ``device``: K6 on the card, the plain version on
    the CPU."""
    return "kernel" if device.type == "cuda" else "plain"


def filter_values(rows: int, device: torch.device) -> torch.Tensor:
    """The filter's column: f32 uniform in [0, 160) from seed 0, so the
    predicate keeps about half the rows."""
    return torch.rand(rows, generator=_generator(0, device),
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
    keys = make_keys(_generator(0, device), rows, 1, key_max)
    vals = make_keys(_generator(1, device), rows, 0, 1_000_000)
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
    keys = make_keys(_generator(0, device), rows, 1, 1 << 30)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", default="join",
                    choices=["join", "filter", "aggregate", "sort"])
    ap.add_argument("--config", default="ref_low_selectivity",
                    choices=sorted(PRESETS))
    ap.add_argument("--verify", action="store_true",
                    help="check every result (see the module docstring)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale factor of the join config")
    ap.add_argument("--rows", type=int, default=OP_ROWS,
                    help="row count of --op filter/aggregate/sort")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        eprint("tpujoin_torch.bench: no CUDA device")
        return 1
    if args.op == "join":
        out = bench_join(scaled_config(args.config, args.scale), args.verify)
    else:
        out = run_op(args.op, args.rows, args.verify)
    print(json.dumps(out), flush=True)
    return 0 if out.get("verified") in (None, True) else 1


if __name__ == "__main__":
    sys.exit(main())
