"""The v1 materialize layer: ``tpujoin_torch.ops.hash_join.probe_materialize``
on the count's (lo, counts) at the pairs rounded up to the configuration's
multiple: below one slot a probe row, a searchsorted of the slots into the
rows' offsets; from there, ``fill_forward`` of the rows' markers."""
from __future__ import annotations

from joinbench import compare
from joinbench.calls.plan_materialize import round_up
from tpujoin_torch.ops import hash_join

LAYER = "materialize"
KEEP = ("pairs", "pair_total", "total")
LIMITS = {"pairs_off": 0, "pair_total_gap": 0}


def run(join: dict, cfg: dict) -> None:
    counts = join["counts"]
    capacity = round_up(join["total"], cfg["pair_capacity_multiple"])
    r_ids, s_ids, pair_total, _ = hash_join.probe_materialize(
        join["table"], join["lo"], counts, capacity)
    join.update(pairs=(r_ids, s_ids), pair_total=pair_total,
                path="v1.fill" if capacity >= counts.numel() else "v1.search")


def check(kept: dict, ref) -> dict:
    r_ids, s_ids = kept["pairs"]
    out = compare.pair_checks(r_ids, s_ids, kept["total"], ref)
    out["pair_total_gap"] = abs(int(kept["pair_total"]) - ref.total)
    return out
