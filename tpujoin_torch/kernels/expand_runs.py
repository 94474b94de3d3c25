"""Run expansion: K7b (csrc/expand_pairs.cu), the expand path's pair step.

The port of tpujoin/kernels/expand_runs.py: for each output slot t below
the total, its compacted run r (offsets[r] <= t < offsets[r + 1]) gives the
pair (src[lo[r] + t - offsets[r]], sid[r]); both columns are -1 from the
total on. That is K4 with the gather of the sorted build ids fused in. A
CUDA tensor goes through the kernel, a CPU tensor through
:func:`expand_runs_plain`; anything else raises. The TPU kernel's slabs,
its ``fits`` flag and the run lengths its fit plan read are gone.

On the card one call is two launches, K5's kernels in their gather mode:
the partition pass, which finds each tile's first run, into a scratch the
wrapper allocates (``expand_fill.partition_scratch``), and the fill
kernel walking the runs from a shared-memory window, one tile a block.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build
from tpujoin_torch.kernels.expand_fill import (check_sizes, partition_scratch,
                                               slot_chunks, take_or_neg)



def expand_runs_plain(offsets, lo, sid, src, nonzero: int, total: int,
                      capacity: int):
    """searchsorted(offsets, t, right=True) - 1, then gathers, PLAIN_CHUNK
    slots at a time."""
    r_out, s_out, steps = slot_chunks(total, capacity, offsets.device)
    if nonzero == 0:
        return r_out, s_out
    runs = offsets[:nonzero].long()
    for a, t in steps:
        b = a + t.shape[0]
        r = (torch.searchsorted(runs, t, right=True) - 1).clamp_(0, nonzero - 1)
        r_out[a:b] = take_or_neg(src, lo[r].long() + t - runs[r])
        s_out[a:b] = sid[r]
    return r_out, s_out


def expand_runs(offsets: torch.Tensor, lo: torch.Tensor, sid: torch.Tensor,
                src: torch.Tensor, nonzero: int, total: int, capacity: int):
    """(r_vals, s_ids), each [capacity] int32. The first ``nonzero`` rows
    of ``offsets`` (the exclusive cumsum of the run lengths) are strictly
    increasing; only those rows are read."""
    nonzero, total = int(nonzero), int(total)
    check_sizes("expand_runs", ((nonzero, offsets.shape[0]),
                                (nonzero, lo.shape[0]),
                                (nonzero, sid.shape[0])), total, capacity)
    if _build.on_cpu(offsets, lo, sid, src):
        return expand_runs_plain(offsets, lo, sid, src, nonzero, total,
                                 capacity)
    r_vals = torch.empty(capacity, dtype=torch.int32, device=offsets.device)
    s_ids = torch.empty_like(r_vals)
    _build.check_cuda_i32(offsets, lo, sid, src, r_vals, s_ids)
    if capacity:
        parts, rows = partition_scratch(total, capacity, r_vals.device)
        _build.call("tj_expand_runs", r_vals.device, offsets.data_ptr(),
                    lo.data_ptr(), sid.data_ptr(), nonzero, src.data_ptr(),
                    src.shape[0], total, r_vals.data_ptr(), s_ids.data_ptr(),
                    capacity, parts.data_ptr(), rows)
    return r_vals, s_ids
