"""Expansion: K4 (csrc/expand.cu), the materialize phase's pair step.

The port of tpujoin/kernels/expand.py: for each output slot t < capacity,
the compacted row r with offsets[r] <= t < offsets[r + 1], and from it
bpos = lo[r] + t - offsets[r] and sid_out = sid[r]. Slots at or past the
true total read the last row and carry no pair; the caller masks them.
A CUDA tensor goes through the kernel, a CPU tensor through
:func:`expand_plain`; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

LAUNCHES = 0


def expand_plain(offsets: torch.Tensor, lo: torch.Tensor, sid: torch.Tensor,
                 capacity: int):
    """searchsorted(offsets, t, right=True) - 1, then two gathers."""
    t = torch.arange(capacity, dtype=torch.int32, device=offsets.device)
    r = torch.searchsorted(offsets, t, right=True, out_int32=True) - 1
    r = r.clamp(0, offsets.shape[0] - 1).long()
    return lo[r] + (t - offsets[r]), sid[r]


def expand(offsets: torch.Tensor, lo: torch.Tensor, sid: torch.Tensor,
           capacity: int):
    """(bpos, sid_out), each [capacity] int32. ``offsets`` is the exclusive
    cumsum of the compacted counts (non-decreasing), ``lo`` the rows' build
    lower bounds, ``sid`` their probe ids."""
    global LAUNCHES
    k = offsets.shape[0]
    if k == 0 or lo.shape[0] != k or sid.shape[0] != k:
        raise ValueError("expand: need K >= 1 rows of offsets, lo and sid")
    if not 0 <= capacity < 2**31:
        raise ValueError(f"expand: capacity {capacity} is not an i32 slot")
    if _build.on_cpu(offsets, lo, sid):
        return expand_plain(offsets, lo, sid, capacity)
    bpos = torch.empty(capacity, dtype=torch.int32, device=offsets.device)
    sid_out = torch.empty_like(bpos)
    _build.check_cuda_i32(offsets, lo, sid, bpos, sid_out)
    if capacity:
        _build.call("tj_expand", bpos.device, offsets.data_ptr(),
                    lo.data_ptr(), sid.data_ptr(), k, bpos.data_ptr(),
                    sid_out.data_ptr(), capacity)
        LAUNCHES += 1
    return bpos, sid_out
