"""Join benchmark of the port: the v2 sort-merge join, phase by phase.

The port of ``bench.py:bench_join`` (its ``engine == "v2"`` branch) and of
``bench_join_dense``, which it takes for the high-selectivity configs
(expected result above 2.5e8 pairs). Keys are made on the card from the
config's seed; each phase is timed as the minimum of three synchronized
runs after one warm-up. stdout is one JSON line with the same keys as the
JAX entry; per-phase detail goes to stderr. ``--verify`` checks every
result pair: against the native oracle as an exact multiset, or for a
dense config, the factorized (RLE) result against the native RLE oracle
and every materialized slot against that verified form by window
checksums.

Usage: python -m tpujoin_torch.bench [--config NAME] [--verify] [--scale F]

It needs a CUDA device.
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
from tpujoin_torch.ops.merge_join import (plan_materialize, probe_count,
                                          probe_materialize, probe_rle)
from tpujoin_torch.utils import verify as vf
from tpujoin_torch.utils.hw import hbm_peak_gbps
from tpujoin_torch.utils.shapes import round_up
from tpujoin_torch.utils.timing import sync, time_fn

DENSE_MATCHES = 2.5e8   # above this, bench.py takes its RLE/fill path
# the most pairs bench_join_dense materializes (two i32 columns, 10 GB);
# above it the factorized result alone is the join
MAX_MATERIALIZED = (1 << 30) + (1 << 28)


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
