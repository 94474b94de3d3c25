"""Multi-column equi-join and filter pushdown (the port of
tpujoin/ops/multi_join.py).

Composite keys are reduced to one i32 *candidate* key by mixing the
per-column hashes (:func:`tpujoin_torch.ops.radix.hash32`, a Boost-style
hash_combine). Equal tuples get equal candidate keys; unequal tuples
collide only at hash probability. The single-key v2 join then gives a
candidate pair superset, and an exact post-filter keeps the pairs whose key
columns are all equal, compacted by K6a, so the result is the exact
multiset.

Candidate keys are folded onto 0x7FFFFFFD at most, so the pushdown's pad
keys, 0x7FFFFFFF on the build side and 0x7FFFFFFE on the probe side, match
no real key and not each other. The pushdown compacts (candidate key, row
id) under the predicate with K3 ``compact3``, the JAX package's
``_push_kernel``; its sort fallbacks ``_push_sort2``/``_push_sort3`` serve
the TPU kernel's envelope, which Hopper's compaction does not have.
"""
from __future__ import annotations

import torch

from tpujoin_torch.core.table import Table, as_table
from tpujoin_torch.kernels.compact import compact3
from tpujoin_torch.ops import merge_join as mj
from tpujoin_torch.ops.filter import filter_materialize
from tpujoin_torch.ops.radix import hash32
from tpujoin_torch.utils.shapes import round_up

KEY_MAX = 0x7FFFFFFD        # the largest candidate key
R_PAD_KEY = 0x7FFFFFFF      # pushdown pad key, build side
S_PAD_KEY = 0x7FFFFFFE      # pushdown pad key, probe side
_MASK32 = (1 << 32) - 1
_GOLDEN32 = 0x9E3779B9


def combined_key(table: Table, on: list[str]) -> torch.Tensor:
    """One i32 candidate key per row from the named key columns, at most
    KEY_MAX. The uint32 arithmetic runs in int64 masked to 32 bits."""
    cols = [table[c] for c in on]
    if len(cols) == 1:
        return cols[0].to(torch.int32).clamp(max=KEY_MAX)
    h = hash32(cols[0].to(torch.int32))
    for c in cols[1:]:
        mix = (hash32(c.to(torch.int32)) + _GOLDEN32 + ((h << 6) & _MASK32)
               + (h >> 2)) & _MASK32
        h = hash32(h ^ mix)
    h = torch.where(h > 0x7FFFFFFF, h - (1 << 32), h)   # the i32 bits
    return h.to(torch.int32).clamp(max=KEY_MAX)


def _exact_filter(r_cols, s_cols, cand_r: torch.Tensor, cand_s: torch.Tensor,
                  capacity: int):
    """(out_r, out_s, total): the candidate pairs whose key columns are all
    equal, in order, -1 from slot ``total`` on; pad candidates (id -1) are
    dropped."""
    valid = cand_r >= 0
    safe_r = torch.where(valid, cand_r, 0).long()
    safe_s = torch.where(valid, cand_s, 0).long()
    eq = valid
    for rc, sc in zip(r_cols, s_cols, strict=True):
        eq = eq & (rc[safe_r] == sc[safe_s])
    slots, total = filter_materialize(eq, capacity)
    keep = slots >= 0
    sel = slots.clamp(0, cand_r.shape[0] - 1).long()
    neg = torch.tensor(-1, dtype=torch.int32, device=slots.device)
    return (torch.where(keep, cand_r[sel], neg),
            torch.where(keep, cand_s[sel], neg), int(total))


def _take_pad(full: torch.Tensor, ids: torch.Tensor,
              pad_key: int) -> torch.Tensor:
    """full[ids], with ``pad_key`` where an id is negative."""
    got = full[ids.clamp(0, full.shape[0] - 1).long()]
    return torch.where(ids >= 0, got, torch.tensor(pad_key, dtype=full.dtype,
                                                   device=full.device))


def _push(table: Table, pred, col: str | None, pad_key: int, on,
          result_pad_multiple: int):
    """One side's pushdown: (kept row ids, candidate keys) at the kept
    count rounded up to ``result_pad_multiple``, ids ascending, the tail
    keyed ``pad_key`` with id -1; (None, None) when no row is kept, and
    every row when there is no predicate."""
    hk_full = combined_key(table, on)
    n = table.num_rows
    if pred is None:
        return torch.arange(n, dtype=torch.int32,
                            device=hk_full.device), hk_full
    mask = pred(table[col])
    total = int(mask.sum(dtype=torch.int64))
    if total == 0:
        return None, None
    cap = round_up(total, result_pad_multiple)
    ids = torch.arange(n, dtype=torch.int32, device=hk_full.device)
    hk_c, _, ids_c = compact3(hk_full, mask.to(torch.int32), ids, cap)
    tail = torch.arange(cap, device=hk_c.device) >= total
    return (ids_c.masked_fill(tail, -1), hk_c.masked_fill(tail, pad_key))


def _join_candidates(hk_r: torch.Tensor, hk_s: torch.Tensor,
                     result_pad_multiple: int):
    """The v2 join of the candidate keys: (cand_r, cand_s, capacity), or
    None when nothing matches."""
    ht = mj.build(hk_r)
    state, total, nonzero = mj.probe_count(ht, hk_s)
    total, nonzero = int(total), int(nonzero)
    if total == 0:
        return None
    cap = round_up(total, result_pad_multiple)
    k_cap = round_up(nonzero, max(result_pad_multiple // 8, 1024))
    _, (cand_r, cand_s, _), _ = mj.plan_materialize(
        ht, state, k_cap, cap, total=total, nonzero=nonzero)
    return cand_r, cand_s, cap


def _result(out_r, out_s, total: int, return_numpy: bool):
    if return_numpy:
        return out_r[:total].cpu().numpy(), out_s[:total].cpu().numpy()
    return out_r, out_s, total


def _empty(device, return_numpy: bool):
    e = torch.empty(0, dtype=torch.int32, device=device)
    return _result(e, e, 0, return_numpy)


def hash_join_multi(r, s, on: list[str] | str, *,
                    device: torch.device | str | None = None,
                    result_pad_multiple: int = 1 << 16,
                    return_numpy: bool = True):
    """Equi-join on every column of ``on``: the exact multiset of (r id,
    s id) pairs as numpy int32 arrays, or with ``return_numpy=False``
    (out_r, out_s, total) on the device, the first ``total`` slots valid.
    ``r`` and ``s`` are Tables, or mappings of numpy arrays that go to
    ``device`` (default CUDA)."""
    if isinstance(on, str):
        on = [on]
    r, s = as_table(r, device), as_table(s, device)
    cand = _join_candidates(combined_key(r, on), combined_key(s, on),
                            result_pad_multiple)
    if cand is None:
        return _empty(r.device, return_numpy)
    cand_r, cand_s, cap = cand
    out = _exact_filter([r[c] for c in on], [s[c] for c in on], cand_r,
                        cand_s, cap)
    return _result(*out, return_numpy)


def join_with_pushdown(r, s, on: list[str] | str, *, r_pred=None,
                       s_pred=None, r_pred_col: str | None = None,
                       s_pred_col: str | None = None,
                       device: torch.device | str | None = None,
                       result_pad_multiple: int = 1 << 16,
                       return_numpy: bool = True):
    """Filter-pushdown join: each side's predicate (an elementwise torch
    function of its ``*_pred_col``) applied before the join, then the join
    of the kept rows on ``on``; ids refer to the original tables. Returns
    as :func:`hash_join_multi`."""
    if isinstance(on, str):
        on = [on]
    r, s = as_table(r, device), as_table(s, device)
    r_kept, hk_r = _push(r, r_pred, r_pred_col, R_PAD_KEY, on,
                         result_pad_multiple)
    s_kept, hk_s = _push(s, s_pred, s_pred_col, S_PAD_KEY, on,
                         result_pad_multiple)
    if hk_r is None or hk_s is None:
        return _empty(r.device, return_numpy)
    cand = _join_candidates(hk_r, hk_s, result_pad_multiple)
    if cand is None:
        return _empty(r.device, return_numpy)
    cand_r, cand_s, cap = cand
    cand_r = _take_pad(r_kept, cand_r, -1)   # kept position -> row id
    cand_s = _take_pad(s_kept, cand_s, -1)
    out = _exact_filter([r[c] for c in on], [s[c] for c in on], cand_r,
                        cand_s, cap)
    return _result(*out, return_numpy)

