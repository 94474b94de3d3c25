"""Hash aggregate: group-by count and per-group (count, sum, min, max) over
an i32 key column (the port of tpujoin/ops/aggregate.py).

One of the extension operators BASELINE.json requires ("hash aggregate
(group-by count), 100M rows"). No hash table: sort the keys, mark the run
boundaries and compact them; every statistic is then adjacent-slot
arithmetic on the compacted columns. On the card the sort is ``torch.sort``
(the JAX package's is ``jax.lax.sort``, an XLA sort and not a Pallas
kernel), the boundary compaction K6a ``compact_ids`` and the value path's
compaction one 6-column K6b ``compact_cols`` pass. Prefix sums are native
int64 ``torch.cumsum``: the JAX package's blockwise hi16/lo16 cumsum and
its gather fallback exist for the TPU only.
"""
from __future__ import annotations

import numpy as np
import torch

from tpujoin_torch.kernels.compact import compact_cols
from tpujoin_torch.ops.filter import filter_materialize
from tpujoin_torch.utils.device import resolve_device
from tpujoin_torch.utils.shapes import round_up

_WORD = 1 << 32
_BIAS = 1 << 31


def _group_starts(sk: torch.Tensor) -> torch.Tensor:
    """The bool mask of the rows of sorted keys ``sk`` that start a group
    (the first row and each row whose key differs from the one before)."""
    first = torch.ones(min(sk.shape[0], 1), dtype=torch.bool,
                       device=sk.device)
    return torch.cat([first, sk[1:] != sk[:-1]])


def group_count(keys: torch.Tensor) -> torch.Tensor:
    """Count phase: the number of distinct keys (0-d int64)."""
    return _group_starts(torch.sort(keys).values).sum(dtype=torch.int64)


def group_materialize(keys: torch.Tensor, capacity: int):
    """Materialize phase: (unique_keys, counts, num_groups), keys ascending,
    padded to capacity (pad keys -1, pad counts 0); ``num_groups`` is a 0-d
    int64 tensor."""
    n, dev = keys.shape[0], keys.device
    sk = torch.sort(keys).values
    starts, num_groups = filter_materialize(_group_starts(sk), capacity)
    if n == 0:
        return starts, torch.zeros_like(starts), num_groups
    valid = starts >= 0
    safe_starts = torch.where(valid, starts, 0)
    group_keys = torch.where(valid, sk[safe_starts.long()], -1)
    # count of group g = start of group g+1 (n for the last group) - start
    next_start = torch.cat([starts[1:], starts.new_full((1,), -1)])
    is_last = torch.arange(capacity, device=dev) == num_groups - 1
    ends = torch.where(is_last, n, next_start)
    counts = torch.where(valid, ends - safe_starts, 0)
    return group_keys, counts, num_groups


def _sort_pairs_lex(keys: torch.Tensor, values: torch.Tensor):
    """(keys, values) sorted by key, then value, with one sort of the
    packed int64 key * 2^32 + (value + 2^31). Ties are fully equal rows, so
    the sort need not be stable."""
    packed = torch.sort(keys.long() * _WORD + (values.long() + _BIAS)).values
    sk = torch.div(packed, _WORD, rounding_mode="floor")
    return sk.int(), (packed - sk * _WORD - _BIAS).int()


def _low_word(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as an int32 (two's complement)."""
    lo = x & (_WORD - 1)
    return torch.where(lo >= _BIAS, lo - _WORD, lo).int()


def value_columns(keys: torch.Tensor, values: torch.Tensor):
    """The value path up to its compaction: (group-start mask, the six i32
    columns (key, row index, value, previous value, previous prefix sum's
    hi and lo words) in (key, value) order, the last value, the total
    sum), the last two 0-d."""
    n = keys.shape[0]
    sk, sv = _sort_pairs_lex(keys, values)
    cs = torch.cumsum(sv, 0, dtype=torch.int64)
    cs_prev = cs - sv                            # exclusive prefix sum
    ph = torch.div(cs_prev, _WORD, rounding_mode="floor").int()
    sv_prev = torch.cat([sv.new_zeros(min(n, 1)), sv[:-1]])
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    last_val = sv[n - 1] if n else sv.new_zeros(())
    total = cs[-1] if n else cs.new_zeros(())
    return (_group_starts(sk), (sk, idx, sv, sv_prev, ph, _low_word(cs_prev)),
            last_val, total)


def group_agg_materialize(keys: torch.Tensor, values: torch.Tensor,
                          capacity: int):
    """Per-group (count, sum, min, max) over a value column: (group_keys,
    counts, sums, mins, maxs, num_groups), padded to capacity (pad keys -1,
    the rest 0). Sums are exact int64.

    (key, value) pairs are sorted with value as the tiebreaker, so a run's
    min and max are its first and last values. One K6b pass compacts the
    :func:`value_columns` at the group-start mask; each statistic then
    comes from adjacent compacted slots. The prefix sum travels as two i32
    words to keep K6b's i32 contract, as in the JAX kernel path."""
    n = keys.shape[0]
    mask, cols, last_val, total64 = value_columns(keys, values)
    (gk_c, idx_c, min_c, pmax_c, ph_c, plo_c), num_groups = compact_cols(
        mask, cols, capacity)

    cap_i = torch.arange(capacity, device=keys.device)
    valid = cap_i < num_groups
    is_last = cap_i == num_groups - 1
    zero32, zero64 = gk_c.new_zeros(1), total64.new_zeros(1)
    group_keys = torch.where(valid, gk_c, -1)
    nxt_idx = torch.cat([idx_c[1:], zero32])
    counts = torch.where(valid, torch.where(is_last, n, nxt_idx) - idx_c, 0)
    mins = torch.where(valid, min_c, 0)
    # group g's max is the value before group g+1's start (the last
    # group's is the last value)
    nxt_pmax = torch.cat([pmax_c[1:], zero32])
    maxs = torch.where(valid, torch.where(is_last, last_val, nxt_pmax), 0)
    pre = ph_c.long() * _WORD + (plo_c.long() & (_WORD - 1))
    nxt_pre = torch.cat([pre[1:], zero64])
    sums = torch.where(valid, torch.where(is_last, total64, nxt_pre) - pre, 0)
    return group_keys, counts, sums, mins, maxs, num_groups


def group_by_agg(keys, values, *, device: torch.device | str | None = None,
                 pad_multiple: int = 1 << 16):
    """Driver: exact-size per-group (key, count, sum, min, max) as numpy
    arrays, keys ascending, sums exact int64. Keys and values are numpy
    arrays or tensors; ``device`` defaults to the tensors' device, else
    CUDA."""
    dev = resolve_device(keys, values, device=device)
    k = torch.as_tensor(keys, dtype=torch.int32, device=dev)
    v = torch.as_tensor(values, dtype=torch.int32, device=dev)
    ngroups = int(group_count(k))
    if ngroups == 0:
        e = np.empty(0, np.int32)
        return e, e, np.empty(0, np.int64), e, e
    out = group_agg_materialize(k, v, round_up(ngroups, pad_multiple))
    return tuple(c[:ngroups].cpu().numpy() for c in out[:5])


def group_by_count(keys, *, device: torch.device | str | None = None,
                   pad_multiple: int = 1 << 16):
    """Driver: exact-size (unique_keys, counts) as numpy int32 arrays, keys
    ascending. ``device`` as in :func:`group_by_agg`."""
    dev = resolve_device(keys, device=device)
    k = torch.as_tensor(keys, dtype=torch.int32, device=dev)
    ngroups = int(group_count(k))
    if ngroups == 0:
        return np.empty((0,), np.int32), np.empty((0,), np.int32)
    gk, gc, _ = group_materialize(k, round_up(ngroups, pad_multiple))
    return gk[:ngroups].cpu().numpy(), gc[:ngroups].cpu().numpy()
