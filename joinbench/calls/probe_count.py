"""The count layer: ``tpujoin_torch.ops.merge_join.probe_count`` (the probe
keys sorted with their ids, K1; each row's matches, K2; the totals) and
its read of the total and the matched rows to the host."""
from __future__ import annotations

from joinbench import compare
from tpujoin_torch.ops import merge_join

LAYER = "count"
KEEP = ("state", "total", "nonzero")
LIMITS = {"count_total_gap": 0, "count_nonzero_gap": 0, "count_rows_off": 0}


def run(join: dict, cfg: dict) -> None:
    state, total, nonzero = merge_join.probe_count(join["table"],
                                                   join["probe_keys"])
    join.update(state=state, total=int(total), nonzero=int(nonzero))


def check(kept: dict, ref) -> dict:
    state = kept["state"]
    return compare.count_checks(state.probe_ids, state.counts, kept["total"],
                                kept["nonzero"], ref)
