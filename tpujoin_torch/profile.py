"""Device time of one join, by kernel, and the device's busy share.

Runs the v2 join of a config (build, count, the count's totals to the host,
materialize, as ``merge_join`` runs one chunk) once to warm up, once under
the host clock alone and once under ``torch.profiler``. Device time comes
from the trace's device rows only (kernels, copies, fills): the CPU
operators' device totals count each of their kernels a second time. The
busy share is the union of the device rows' intervals over the host wall
time of the traced join, which ends in a synchronize.

stdout is one JSON line; the kernel table goes to stderr.

Usage: python -m tpujoin_torch.profile [--config NAME] [--scale F]

It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import torch

from tpujoin_torch.bench import DENSE_MATCHES, eprint, scaled_config
from tpujoin_torch.core.config import PRESETS, JoinConfig
from tpujoin_torch.core.datagen import make_keys
from tpujoin_torch.ops.hash_join import build
from tpujoin_torch.ops.merge_join import probe_count, probe_materialize
from tpujoin_torch.utils.shapes import round_up


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def join_once(cfg: JoinConfig, bk: torch.Tensor, pk: torch.Tensor):
    ht = build(bk)
    state, total, nonzero = probe_count(ht, pk)
    cap = round_up(int(total), cfg.result_pad_multiple)
    k_cap = round_up(int(nonzero), max(cfg.result_pad_multiple // 8, 1024))
    return probe_materialize(ht, state, k_cap, cap, total=total,
                             nonzero=nonzero)


def _timed_join(cfg, bk, pk) -> float:
    t0 = time.perf_counter()
    join_once(cfg, bk, pk)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_join(cfg: JoinConfig) -> dict:
    """Profile one join of ``cfg`` on the current CUDA device; return the
    summary dict, kernels by device time."""
    if cfg.expected_matches > DENSE_MATCHES:
        raise NotImplementedError(
            f"{cfg.name}: the high-selectivity materialize path is not ported")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    bk = make_keys(gen, cfg.build_rows, cfg.key_min, cfg.key_max,
                   cfg.distribution, cfg.zipf_s)
    pk = make_keys(gen, cfg.probe_rows, cfg.key_min, cfg.key_max,
                   cfg.distribution, cfg.zipf_s)
    _timed_join(cfg, bk, pk)   # warm-up: builds and loads the kernels
    untraced = _timed_join(cfg, bk, pk)
    torch.cuda.reset_peak_memory_stats(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        window = _timed_join(cfg, bk, pk)
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
        "config": cfg.name,
        "device": torch.cuda.get_device_name(dev),
        "build_rows": cfg.build_rows,
        "probe_rows": cfg.probe_rows,
        "untraced_ms": untraced * 1e3,
        "traced_ms": window * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_rows_ms": sum(k["ms"] for k in kernels),
        "busy_share": busy_us / (window * 1e6),
        "peak_gib": peak / 2**30,
        "kernels": kernels,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="ref_low_selectivity",
                    choices=sorted(PRESETS))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale factor")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        eprint("tpujoin_torch.profile: no CUDA device")
        return 1
    out = profile_join(scaled_config(args.config, args.scale))
    for k in out["kernels"]:
        eprint(f"{k['ms']:10.3f} ms {k['calls']:5d}  {k['name'][:100]}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
