"""Sort-merge probe pipeline, the v2 engine (the port of
tpujoin/ops/merge_join.py, low-selectivity path).

  count:       sort the probe (key, id) pairs (K1) -> merge_count (K2)
  materialize: compact the rows with matches (K3) -> cumsum -> expand (K4)
               -> gather of the sorted build ids

Results come out in sorted-probe order; the join result is an unordered
multiset, checked as one by the oracle, so nothing is unsorted.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpujoin_torch.kernels.compact import compact3
from tpujoin_torch.kernels.expand import expand
from tpujoin_torch.kernels.merge_count import merge_count
from tpujoin_torch.kernels.merge_sort import sort_pairs
from tpujoin_torch.ops.hash_join import HashJoinTable, _i32_tensor, build
from tpujoin_torch.utils.shapes import round_up

# pads the last probe chunk: sorts to the tail and matches nothing in the
# benchmark key domain [1, 1e9]
CHUNK_PAD_KEY = 0x7FFFFFFE


@dataclasses.dataclass
class SortedProbe:
    """Count-phase state, all in sorted-probe-key order."""

    probe_ids: torch.Tensor   # [m] original probe row ids under the sort
    lo: torch.Tensor          # [m] lower bound in the sorted build keys
    counts: torch.Tensor      # [m] match counts

    @classmethod
    def from_numpy(cls, probe_ids: np.ndarray, lo: np.ndarray,
                   counts: np.ndarray,
                   device: torch.device | str = "cpu") -> "SortedProbe":
        """State from another implementation (e.g. the JAX package's)."""
        return cls(_i32_tensor(probe_ids, device), _i32_tensor(lo, device),
                   _i32_tensor(counts, device))


def probe_count(ht: HashJoinTable, probe_keys: torch.Tensor):
    """Count phase. Returns (state, total, nonzero) with ``total`` the exact
    result size (0-d int64 tensor) and ``nonzero`` the number of probe rows
    with at least one match (0-d int64 tensor)."""
    m = probe_keys.shape[0]
    ids = torch.arange(m, dtype=torch.int32, device=probe_keys.device)
    psk, pid = sort_pairs(probe_keys, ids)
    lo, cnt = merge_count(ht.sorted_keys, psk)
    total = cnt.sum(dtype=torch.int64)
    nonzero = (cnt > 0).sum()
    return SortedProbe(pid, lo, cnt), total, nonzero


def _compact(state: SortedProbe, k_cap: int, total, nonzero):
    """Compact the count state to the rows with >= 1 match, at width k_cap.
    ``total`` and ``nonzero`` are probe_count's. Returns (lo_c, cnt_c,
    sid_c, offs_c, total, nonzero); offs_c is the exclusive cumsum of cnt_c
    (int32: a result slot is an i32)."""
    lo_c, cnt_c, sid_c = compact3(state.lo, state.counts, state.probe_ids,
                                  k_cap)
    offs_c = torch.cumsum(cnt_c, 0, dtype=torch.int32) - cnt_c
    return lo_c, cnt_c, sid_c, offs_c, total, nonzero


def probe_materialize(ht: HashJoinTable, state: SortedProbe, k_cap: int,
                      capacity: int, probe_base: int = 0, *, total, nonzero):
    """Materialize phase at capacities k_cap >= nonzero rows and
    capacity >= total pairs, where ``total`` and ``nonzero`` are
    probe_count's (ints or 0-d tensors). Returns (r_ids, s_ids, total,
    fits), each id column [capacity] int32 with -1 in the slots past the
    total. ``fits`` (0-d bool tensor) is False when either capacity is too
    small; the output is then a truncated multiset."""
    lo_c, _, sid_c, offs_c, total, nonzero = _compact(state, k_cap, total,
                                                      nonzero)
    bpos, sid_out = expand(offs_c, lo_c, sid_c, capacity)
    dev = bpos.device
    total = torch.as_tensor(total, dtype=torch.int64, device=dev)
    nonzero = torch.as_tensor(nonzero, dtype=torch.int64, device=dev)
    t = torch.arange(capacity, dtype=torch.int64, device=dev)
    valid = t < total
    bpos = bpos.clamp(0, ht.num_rows - 1).long()
    neg = torch.tensor(-1, dtype=torch.int32, device=dev)
    r_ids = torch.where(valid, ht.sorted_ids[bpos], neg)
    s_ids = torch.where(valid, sid_out + probe_base, neg)
    fits = (total <= capacity) & (nonzero <= k_cap)
    return r_ids, s_ids, total, fits


def plan_materialize(ht: HashJoinTable, state: SortedProbe, k_cap: int,
                     capacity: int, *, total: int, nonzero: int,
                     probe_base: int = 0):
    """The materialize path for this workload, as (name, results, replay):
    ``results`` is (r_ids, s_ids, total) already computed and ``replay()``
    runs the same call again. The port has one path, "expand"; ``total``
    and ``nonzero`` will choose among the paths still to port."""

    def replay():
        return probe_materialize(ht, state, k_cap, capacity, probe_base,
                                 total=total, nonzero=nonzero)[:3]

    return "expand", replay(), replay


def merge_join(build_keys, probe_keys, *,
               device: torch.device | str | None = None,
               probe_chunk_rows: int | None = None,
               result_pad_multiple: int = 1 << 20):
    """Full join on the v2 pipeline: all (rowID_R, rowID_S) pairs with
    equal keys, as exact-size numpy int32 arrays. Keys are numpy arrays or
    tensors; ``device`` defaults to the tensors' device, else the CPU. The
    probe side runs in chunks of ``probe_chunk_rows`` (all at once when
    None), the last chunk padded with CHUNK_PAD_KEY."""
    if device is None:
        device = getattr(build_keys, "device", "cpu")
    bk = torch.as_tensor(build_keys, dtype=torch.int32, device=device)
    pk = torch.as_tensor(probe_keys, dtype=torch.int32, device=device)
    m = pk.shape[0]
    chunk = m if probe_chunk_rows is None else min(probe_chunk_rows, max(m, 1))

    ht = build(bk)
    out_r, out_s = [], []
    for start in range(0, m, chunk) if m else []:
        end = min(start + chunk, m)
        part = pk[start:end]
        if end - start < chunk:
            part = torch.cat([part, part.new_full((chunk - (end - start),),
                                                  CHUNK_PAD_KEY)])
        state, total, nonzero = probe_count(ht, part)
        total, nonzero = int(total), int(nonzero)
        if total == 0:
            continue
        cap = round_up(total, result_pad_multiple)
        k_cap = round_up(nonzero, max(result_pad_multiple // 8, 1024))
        _, (r_ids, s_ids, _), _ = plan_materialize(
            ht, state, k_cap, cap, total=total, nonzero=nonzero,
            probe_base=start)
        out_r.append(r_ids[:total].cpu().numpy())
        out_s.append(s_ids[:total].cpu().numpy())

    if not out_r:
        return np.empty((0,), np.int32), np.empty((0,), np.int32)
    return np.concatenate(out_r), np.concatenate(out_s)
