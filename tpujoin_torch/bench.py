"""Join benchmark of the port: the v2 sort-merge join, phase by phase.

The port of ``bench.py:bench_join`` (its ``engine == "v2"`` branch). Keys
are made on the card from the config's seed; build, count and materialize
are each timed as the minimum of three synchronized runs after one warm-up.
stdout is one JSON line with the same keys as the JAX entry; per-phase
detail goes to stderr. ``--verify`` checks every result pair against the
native oracle as an exact multiset.

Usage: python -m tpujoin_torch.bench [--config NAME] [--verify] [--scale F]

It needs a CUDA device; the high-selectivity configs (expected result
above 2.5e8 pairs) take a path that is not ported yet and are refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from tpujoin_torch import oracle
from tpujoin_torch.core.config import PRESETS, JoinConfig
from tpujoin_torch.core.datagen import make_keys
from tpujoin_torch.ops.hash_join import build
from tpujoin_torch.ops.merge_join import probe_count, probe_materialize
from tpujoin_torch.utils.hw import hbm_peak_gbps
from tpujoin_torch.utils.shapes import round_up
from tpujoin_torch.utils.timing import sync, time_fn

DENSE_MATCHES = 2.5e8   # above this, bench.py takes its RLE/fill path


def eprint(*a):
    print(*a, file=sys.stderr, flush=True)


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
    the summary dict (``verified`` is None unless ``verify``)."""
    if cfg.expected_matches > DENSE_MATCHES:
        raise NotImplementedError(
            f"{cfg.name}: the high-selectivity materialize path is not ported")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    bk = make_keys(gen, cfg.build_rows, cfg.key_min, cfg.key_max,
                   cfg.distribution, cfg.zipf_s)
    pk = make_keys(gen, cfg.probe_rows, cfg.key_min, cfg.key_max,
                   cfg.distribution, cfg.zipf_s)
    sync(device)

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
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="ref_low_selectivity",
                    choices=sorted(PRESETS))
    ap.add_argument("--verify", action="store_true",
                    help="check every pair against the native oracle")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row-count scale factor")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        eprint("tpujoin_torch.bench: no CUDA device")
        return 1
    out = bench_join(scaled_config(args.config, args.scale), args.verify)
    print(json.dumps(out), flush=True)
    return 0 if out["verified"] in (None, True) else 1


if __name__ == "__main__":
    sys.exit(main())
