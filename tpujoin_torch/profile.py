"""Device time of one operation, by kernel, and the device's busy share.

The operation (``--op``) is one join of a config (build, count, the
count's totals to the host, materialize, as ``merge_join`` runs one chunk
on v2 or ``hash_join`` on v1, ``--engine``), one ``filter_device`` over
the bench's filter column, one ``group_agg_materialize`` over the bench's
aggregate keys and values (sort, cumsum, the 6-column compact_cols), or
one ``hash_join_multi`` of the bench's multi-column tables, at the bench's
sizes and capacities.
It runs once to warm up, once under the host clock alone and once under
``torch.profiler``. Device time comes from the trace's device rows only
(kernels, copies, fills): the CPU operators' device totals count each of
their kernels a second time. The busy share is the union of the device
rows' intervals over the host wall time of the traced run, which ends in a
synchronize.

stdout is one JSON line; the kernel table goes to stderr.

Usage: python -m tpujoin_torch.profile [--op join] [--config NAME]
                                       [--engine {v1,v2}] [--scale F]
       python -m tpujoin_torch.profile --op {filter,aggregate,multi_join}
                                       [--rows N]

It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import torch

from tpujoin_torch.bench import (DENSE_MATCHES, FILTER_THRESHOLD, OP_ROWS,
                                 aggregate_inputs, config_keys, eprint,
                                 filter_capacity, filter_values,
                                 multi_join_tables, scaled_config)
from tpujoin_torch.core.config import PRESETS, JoinConfig
from tpujoin_torch.ops import aggregate as agg
from tpujoin_torch.ops import hash_join as hj
from tpujoin_torch.ops.multi_join import hash_join_multi
from tpujoin_torch.ops.filter import filter_device
from tpujoin_torch.ops.hash_join import build
from tpujoin_torch.ops.merge_join import plan_materialize, probe_count
from tpujoin_torch.utils.shapes import round_up


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def join_once(cfg: JoinConfig, bk: torch.Tensor, pk: torch.Tensor,
              engine: str = "v2"):
    """One join's pair columns, on v2 on the path plan_materialize picks,
    at the capacities the bench gives ``cfg``; or on v1 at its total
    rounded up to the config's pad."""
    ht = build(bk)
    if engine == "v1":
        lo, counts = hj.probe_count(ht, pk)
        cap = round_up(int(counts.sum(dtype=torch.int64)),
                       cfg.result_pad_multiple)
        return hj.probe_materialize(ht, lo, counts, cap)
    state, total, nonzero = probe_count(ht, pk)
    total, nonzero = int(total), int(nonzero)
    cap = round_up(total, cfg.result_pad_multiple)
    k_cap = round_up(nonzero, 1 << 20 if cfg.expected_matches > DENSE_MATCHES
                     else max(cfg.result_pad_multiple // 8, 1024))
    return plan_materialize(ht, state, k_cap, cap, total=total,
                            nonzero=nonzero)[1]


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_fn(fn, dev: torch.device) -> dict:
    """Run ``fn`` to warm up (which builds and loads the kernels), then
    untraced and traced; return the timings, the busy share, the peak
    allocation and the kernels by device time."""
    _timed(fn)
    untraced = _timed(fn)
    torch.cuda.reset_peak_memory_stats(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        window = _timed(fn)
    peak = torch.cuda.max_memory_allocated(dev)

    rows = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0, 0.0])
    for e in rows:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy_us = union_length((e.time_range.start, e.time_range.end)
                           for e in rows)
    kernels = sorted(({"name": name, "calls": c, "ms": us / 1e3}
                      for name, (c, us) in by_name.items()),
                     key=lambda k: -k["ms"])
    return {
        "device": torch.cuda.get_device_name(dev),
        "untraced_ms": untraced * 1e3,
        "traced_ms": window * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_rows_ms": sum(k["ms"] for k in kernels),
        "busy_share": busy_us / (window * 1e6),
        "peak_gib": peak / 2**30,
        "kernels": kernels,
    }


def _device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device())


def profile_join(cfg: JoinConfig, engine: str = "v2") -> dict:
    """Profile one join of ``cfg`` on the current CUDA device."""
    dev = _device()
    bk, pk = config_keys(cfg, dev)
    out = profile_fn(lambda: join_once(cfg, bk, pk, engine), dev)
    return {"op": "join", "engine": engine, "config": cfg.name,
            "build_rows": cfg.build_rows, "probe_rows": cfg.probe_rows,
            **out}


def profile_multi_join(rows: int) -> dict:
    """Profile one hash_join_multi on (k1, k2) of the bench's tables."""
    dev = _device()
    r, s = multi_join_tables(rows, dev)
    out = profile_fn(lambda: hash_join_multi(r, s, ["k1", "k2"],
                                             return_numpy=False), dev)
    return {"op": "multi_join", "rows": rows, **out}


def profile_filter(rows: int) -> dict:
    """Profile one filter_device over the bench's filter column."""
    dev = _device()
    vals = filter_values(rows, dev)
    cap = filter_capacity(rows)
    out = profile_fn(lambda: filter_device(vals, FILTER_THRESHOLD, cap), dev)
    return {"op": "filter", "rows": rows, **out}


def profile_aggregate(rows: int) -> dict:
    """Profile one group_agg_materialize over the bench's aggregate keys
    and values, at the bench's capacity."""
    dev = _device()
    keys, vals = aggregate_inputs(rows, max(rows // 10, 100), dev)
    ngroups = int(agg.group_count(keys))
    cap = round_up(ngroups, 1 << 20)
    out = profile_fn(lambda: agg.group_agg_materialize(keys, vals, cap), dev)
    return {"op": "aggregate", "rows": rows, "groups": ngroups, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", default="join",
                    choices=["join", "filter", "aggregate", "multi_join"])
    ap.add_argument("--config", default="ref_low_selectivity",
                    choices=sorted(PRESETS))
    ap.add_argument("--engine", default="v2", choices=["v1", "v2"])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale factor of the join config")
    ap.add_argument("--rows", type=int, default=OP_ROWS,
                    help="row count of --op filter/aggregate/multi_join")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        eprint("tpujoin_torch.profile: no CUDA device")
        return 1
    if args.op == "join":
        out = profile_join(scaled_config(args.config, args.scale),
                           args.engine)
    elif args.op == "filter":
        out = profile_filter(args.rows)
    elif args.op == "multi_join":
        out = profile_multi_join(args.rows)
    else:
        out = profile_aggregate(args.rows)
    for k in out["kernels"]:
        eprint(f"{k['ms']:10.3f} ms {k['calls']:5d}  {k['name'][:100]}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
