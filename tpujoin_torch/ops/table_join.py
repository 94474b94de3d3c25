"""Table-level joins: the user's surface over the id-pair joins (the
port of tpujoin/ops/table_join.py).

Every join returns a Table: pair ids from the v2 pipeline (or the
multi-column join), then each side's columns gathered per the nested-loop
convention (r_* columns, s_* columns, S's copy of the first key dropped).
"""
from __future__ import annotations

import torch

from tpujoin_torch.core.table import Table, as_table
from tpujoin_torch.ops.merge_join import (anti_join, left_outer_join,
                                          merge_join, semi_join)
from tpujoin_torch.ops.multi_join import hash_join_multi
from tpujoin_torch.ops.nested_loop_join import materialize_join_rows


def join_tables(r, s, on: str | list[str] = "key", *, how: str = "inner",
                device: torch.device | str | None = None,
                result_pad_multiple: int = 1 << 16) -> Table:
    """Join two tables on one or more key columns and return the
    materialized result. ``how`` is one of:

    - inner: all matching row pairs, columns r_* and s_* (minus S's key);
    - left: inner plus every probe (s) row without a match, which carries
      the r_* columns of R's row 0 and ``r_matched`` False (the probe-side
      outer join of the id-pair join);
    - semi, anti: the S rows with (without) a match, S's own columns.

    ``r`` and ``s`` are Tables, or mappings of numpy arrays that go to
    ``device`` (default CUDA)."""
    r, s = as_table(r, device), as_table(s, device)
    keys = [on] if isinstance(on, str) else list(on)
    key0 = keys[0]
    dev = s.device

    if how in ("semi", "anti"):
        if len(keys) == 1:
            join = semi_join if how == "semi" else anti_join
            ids = torch.as_tensor(join(r[key0], s[key0]), device=dev)
        else:
            matched = _multi_semi(r, s, keys, result_pad_multiple)
            if how == "semi":
                ids = matched
            else:
                ids = _unmatched(matched, s.num_rows)
        return s.gather(ids)

    if how not in ("inner", "left"):
        raise ValueError(f"unknown how={how!r}")
    if len(keys) > 1:
        out_r, out_s, total = hash_join_multi(
            r, s, keys, result_pad_multiple=result_pad_multiple,
            return_numpy=False)
        r_ids, s_ids = out_r[:total], out_s[:total]
        if how == "inner":
            return materialize_join_rows(r, s, r_ids, s_ids, key_column=key0)
        unmatched = _unmatched(torch.unique(s_ids), s.num_rows)
        r_ids = torch.cat([r_ids, torch.zeros_like(unmatched)])
        s_ids = torch.cat([s_ids, unmatched])
        matched = torch.arange(r_ids.shape[0], device=dev) < (
            r_ids.shape[0] - unmatched.shape[0])
    elif how == "inner":
        r_ids, s_ids = merge_join(r[key0], s[key0],
                                  result_pad_multiple=result_pad_multiple)
        return materialize_join_rows(r, s, r_ids, s_ids, key_column=key0)
    else:
        r_ids, s_ids = (torch.as_tensor(x, device=dev) for x in
                        left_outer_join(
                            r[key0], s[key0],
                            result_pad_multiple=result_pad_multiple))
        matched = r_ids >= 0
        r_ids = r_ids.clamp(min=0)
    out = materialize_join_rows(r, s, r_ids, s_ids, key_column=key0)
    return out.with_column("r_matched", matched)


def _multi_semi(r: Table, s: Table, keys: list[str], pad: int):
    """The s ids with a match on every key, ascending and unique."""
    _, s_ids, total = hash_join_multi(r, s, keys, result_pad_multiple=pad,
                                      return_numpy=False)
    return torch.unique(s_ids[:total])


def _unmatched(matched: torch.Tensor, rows: int) -> torch.Tensor:
    """The ids in [0, rows) not in ``matched``, ascending (int32)."""
    keep = torch.ones(rows, dtype=torch.bool, device=matched.device)
    keep[matched.long()] = False
    return torch.nonzero(keep).squeeze(1).to(torch.int32)
