"""The build phase of both engines and the v1 (searchsorted) equi-join (the
port of tpujoin/ops/hash_join.py).

The build side sorted by key plays the hash table: every key's matches are
one contiguous [lo, lo + cnt) range of ``sorted_ids``. The sort is K1
(kernels/merge_sort.py) for a CUDA tensor at every size.

The v1 engine probes the unsorted probe keys into that table:

  count:       two ``torch.searchsorted`` (left and right), as the JAX
               package's XLA searchsorted; no Pallas kernel there, so the
               library call is the counterpart
  materialize: slot t's probe row is the last row whose exclusive-cumsum
               offset is <= t, its build position lo[row] + t - offset.
               Below m slots (low selectivity) one searchsorted of the
               slots into the offsets finds the rows; from m slots on
               (dense) each matched row's index is scattered at its offset
               and forward-filled by ``fill_forward`` (csrc/probe_fill.cu),
               which is what the JAX package's cummax of packed markers
               computes: offsets of matched rows strictly rise, so the last
               marker at or before a slot is its row.

Pairs come out in probe order. Every sum of counts is int64; a capacity of
2^31 slots or more (a result slot is an i32) raises instead of wrapping.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpujoin_torch.kernels.forward_fill import LANES, fill_forward
from tpujoin_torch.kernels.merge_sort import sort_pairs
from tpujoin_torch.utils.device import i32_columns
from tpujoin_torch.utils.shapes import round_up

FILL_STEP = 32768        # fill_forward's tile: the JAX probe kernel's step
MAX_CAPACITY = (1 << 31) - 1   # slots of one materialize (i32 slot ids)


@dataclasses.dataclass
class HashJoinTable:
    """The built side: keys sorted ascending and the row ids under the sort."""

    sorted_keys: torch.Tensor   # [n] i32, ascending
    sorted_ids: torch.Tensor    # [n] i32

    @property
    def num_rows(self) -> int:
        return int(self.sorted_keys.shape[0])

    @classmethod
    def from_numpy(cls, sorted_keys: np.ndarray, sorted_ids: np.ndarray,
                   device: torch.device | str = "cpu") -> "HashJoinTable":
        """A table from another implementation's state (e.g. the JAX
        package's, through ``np.asarray`` of its fields)."""
        return cls(_i32_tensor(sorted_keys, device),
                   _i32_tensor(sorted_ids, device))


def _i32_tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)


def build(build_keys: torch.Tensor) -> HashJoinTable:
    """Build phase: one (key, row id) sort."""
    n = build_keys.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=build_keys.device)
    sk, sid = sort_pairs(build_keys, ids)
    return HashJoinTable(sk, sid)


def probe_count(ht: HashJoinTable, probe_keys: torch.Tensor):
    """Count phase: (lo, counts), each [m] int32 in probe order: the first
    position of the probe key in the sorted build keys and its number of
    matches. The exact result size is ``counts.sum(dtype=torch.int64)``."""
    lo = torch.searchsorted(ht.sorted_keys, probe_keys, out_int32=True)
    hi = torch.searchsorted(ht.sorted_keys, probe_keys, right=True,
                            out_int32=True)
    return lo, hi - lo


def row_markers(offsets: torch.Tensor, counts: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """fill_forward's input for capacity >= m: each matched row's index at
    its offset below ``capacity``, -1 elsewhere, as (slots / 128, 128)
    int32; the slots are ``capacity`` rounded up to whole FILL_STEP tiles
    (the slots past ``capacity`` are cut off after the fill)."""
    m = counts.shape[0]
    slots = round_up(capacity, FILL_STEP)
    mark = torch.full((slots,), -1, dtype=torch.int32, device=counts.device)
    pos = torch.where(counts > 0, offsets, capacity)
    keep = pos < capacity
    mark[pos[keep]] = torch.arange(m, dtype=torch.int32,
                                   device=counts.device)[keep]
    return mark.view(slots // LANES, LANES)


def probe_materialize(ht: HashJoinTable, lo: torch.Tensor,
                      counts: torch.Tensor, capacity: int,
                      probe_base: int = 0):
    """Materialize phase: (r_ids, s_ids, total, fits). The id columns are
    [capacity] int32 with -1 from slot ``total`` on; ``total`` is the exact
    result size (0-d int64) and ``fits`` (0-d bool) whether the capacity
    holds it (else the output is a truncated multiset). s ids are probe
    rows + ``probe_base``."""
    if capacity > MAX_CAPACITY:
        raise ValueError(f"capacity {capacity} needs slot ids past int32")
    dev = counts.device
    m, n = counts.shape[0], ht.num_rows
    offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    total = (offsets[-1] + counts[-1] if m else
             torch.zeros((), dtype=torch.int64, device=dev))
    neg = torch.tensor(-1, dtype=torch.int32, device=dev)
    if n == 0 or m == 0:
        return (neg.expand(capacity).clone(), neg.expand(capacity).clone(),
                total, total <= capacity)
    t = torch.arange(capacity, dtype=torch.int64, device=dev)
    if capacity >= m:
        # slots before the first marker lie past the total (none is valid)
        row = fill_forward(row_markers(offsets, counts, capacity),
                           FILL_STEP).view(-1)[:capacity]
        row = row.long().clamp(min=0)
    else:
        row = (torch.searchsorted(offsets, t, right=True) - 1).clamp(0, m - 1)
    valid = t < total
    bpos = (lo[row].long() - offsets[row] + t).clamp(0, n - 1)
    r_ids = torch.where(valid, ht.sorted_ids[bpos], neg)
    s_ids = torch.where(valid, (row + probe_base).to(torch.int32), neg)
    return r_ids, s_ids, total, total <= capacity


def hash_join(build_keys, probe_keys, *,
              device: torch.device | str | None = None,
              probe_chunk_rows: int | None = None,
              result_pad_multiple: int = 1 << 20,
              return_numpy: bool = True):
    """Full join on the v1 engine: all (rowID_R, rowID_S) pairs with equal
    keys, exact-size int32, in probe order. The probe side runs in chunks
    of ``probe_chunk_rows`` (all at once when None), the last one at its
    own length; each chunk materializes at its total rounded up to
    ``result_pad_multiple``. Returns numpy arrays, or tensors on the
    device with ``return_numpy=False``. Keys are numpy arrays or tensors;
    ``device`` defaults to the tensors' device, else CUDA."""
    bk, pk = i32_columns(build_keys, probe_keys, device=device)
    m = pk.shape[0]
    chunk = m if probe_chunk_rows is None else min(probe_chunk_rows, max(m, 1))

    ht = build(bk)
    out_r, out_s = [], []
    for start in range(0, m, chunk) if m else []:
        lo, counts = probe_count(ht, pk[start:start + chunk])
        total = int(counts.sum(dtype=torch.int64))
        if total == 0:
            continue
        cap = round_up(total, result_pad_multiple)
        r_ids, s_ids, _, fits = probe_materialize(ht, lo, counts, cap,
                                                  probe_base=start)
        if not bool(fits):
            raise RuntimeError("materialize capacity undersized")
        out_r.append(r_ids[:total])
        out_s.append(s_ids[:total])

    empty = torch.empty(0, dtype=torch.int32, device=pk.device)
    r = torch.cat(out_r) if out_r else empty
    s = torch.cat(out_s) if out_s else empty
    if return_numpy:
        return r.cpu().numpy(), s.cpu().numpy()
    return r, s


def hash_join_rle(build_keys, probe_keys, *,
                  device: torch.device | str | None = None):
    """The v1 factorized (RLE) result as numpy int32 arrays (probe_ids, lo,
    cnt, sorted_build_ids): row r expands to the pairs
    (sorted_build_ids[lo[r] + j], probe_ids[r]) for j < cnt[r]. The count
    phase's (lo, counts) in probe order is this result: no expansion."""
    bk, pk = i32_columns(build_keys, probe_keys, device=device)
    ht = build(bk)
    lo, counts = probe_count(ht, pk)
    return (np.arange(pk.shape[0], dtype=np.int32), lo.cpu().numpy(),
            counts.cpu().numpy(), ht.sorted_ids.cpu().numpy())


def hash_join_device(build_keys, probe_keys, capacity: int, *,
                     device: torch.device | str | None = None):
    """Build, count and materialize at a capacity the caller gives: (r_ids,
    s_ids, total, fits) as :func:`probe_materialize` returns them."""
    bk, pk = i32_columns(build_keys, probe_keys, device=device)
    ht = build(bk)
    lo, counts = probe_count(ht, pk)
    return probe_materialize(ht, lo, counts, capacity)
