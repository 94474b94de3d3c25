"""The materialize layer: ``tpujoin_torch.ops.merge_join.plan_materialize``,
the pair columns on the path it picks (expand at low selectivity: K3,
the offsets' cumsum, K7b; fill at high: K5), at the capacities of the
configuration: the pairs and the matched rows rounded up to its
multiples."""
from __future__ import annotations

from joinbench import compare
from tpujoin_torch.ops import merge_join

LAYER = "materialize"
KEEP = ("pairs", "pair_total", "total")
LIMITS = {"pairs_off": 0, "pair_total_gap": 0}


def round_up(x: int, multiple: int) -> int:
    """x rounded up to a multiple, and ``multiple`` where x <= 0."""
    return max(-(-x // multiple), 1) * multiple


def run(join: dict, cfg: dict) -> None:
    total, nonzero = join["total"], join["nonzero"]
    path, (r_ids, s_ids, pair_total), _ = merge_join.plan_materialize(
        join["table"], join["state"],
        round_up(nonzero, cfg["row_capacity_multiple"]),
        round_up(total, cfg["pair_capacity_multiple"]),
        total=total, nonzero=nonzero)
    join.update(pairs=(r_ids, s_ids), pair_total=pair_total, path=path)


def check(kept: dict, ref) -> dict:
    r_ids, s_ids = kept["pairs"]
    out = compare.pair_checks(r_ids, s_ids, kept["total"], ref)
    out["pair_total_gap"] = abs(int(kept["pair_total"]) - ref.total)
    return out
