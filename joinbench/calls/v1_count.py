"""The v1 count layer: ``tpujoin_torch.ops.hash_join.probe_count`` (on the
card the equal-range search of the unsorted probe keys in the sorted
build keys, a key-range directory and then one bounded search a probe
key: each probe row's first match and its number of matches, in probe
order), the int64 totals and their read to the host."""
from __future__ import annotations

import torch

from joinbench import compare
from tpujoin_torch.ops import hash_join

LAYER = "count"
KEEP = ("counts", "total", "nonzero")
LIMITS = {"count_total_gap": 0, "count_nonzero_gap": 0, "count_rows_off": 0}


def run(join: dict, cfg: dict) -> None:
    lo, counts = hash_join.probe_count(join["table"], join["probe_keys"])
    join.update(lo=lo, counts=counts,
                total=int(counts.sum(dtype=torch.int64)),
                nonzero=int((counts > 0).sum()))


def check(kept: dict, ref) -> dict:
    counts = kept["counts"]     # in probe order: row i is probe id i
    ids = torch.arange(counts.numel(), device=counts.device)
    return compare.count_checks(ids, counts, kept["total"], kept["nonzero"],
                                ref)
