"""Stream compaction: K3 (csrc/compact.cu), the materialize phase's first step.

The port of tpujoin/kernels/compact.py's ``compact3``: a stable compaction
of (lo, cnt, sid) to the rows with cnt > 0, at width ``k_cap`` with a zero
tail. The kernel path is a count pass, ``torch.cumsum`` of the block counts
and a scatter pass; the result always fits, so there is no ``fits`` flag.
A CUDA tensor goes through the kernels, a CPU tensor through
:func:`compact3_plain`; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

BLOCK_ROWS = 1024   # rows per block of both passes (BLOCK_ROWS in the .cu)
LAUNCHES = 0        # scatter-kernel launches (each follows one count launch)


def compact3_plain(lo: torch.Tensor, cnt: torch.Tensor, sid: torch.Tensor,
                   k_cap: int):
    """Boolean-mask compaction, cut or zero-padded to k_cap."""
    keep = cnt > 0
    outs = []
    for col in (lo, cnt, sid):
        kept = col[keep][:k_cap]
        out = torch.zeros(k_cap, dtype=col.dtype, device=col.device)
        out[:kept.shape[0]] = kept
        outs.append(out)
    return tuple(outs)


def compact3(lo: torch.Tensor, cnt: torch.Tensor, sid: torch.Tensor,
             k_cap: int):
    """(lo_c, cnt_c, sid_c): the rows with cnt > 0 in input order, the
    first k_cap of them, zero-padded to k_cap."""
    global LAUNCHES
    if _build.on_cpu(lo, cnt, sid):
        return compact3_plain(lo, cnt, sid, k_cap)
    n = cnt.shape[0]
    if lo.shape[0] != n or sid.shape[0] != n:
        raise ValueError("compact3: columns differ in length")
    outs = [torch.empty(k_cap, dtype=torch.int32, device=cnt.device)
            for _ in range(3)]
    _build.check_cuda_i32(lo, cnt, sid, *outs)
    if n == 0:
        return tuple(o.zero_() for o in outs)
    counts = torch.empty(-(-n // BLOCK_ROWS), dtype=torch.int32,
                         device=cnt.device)
    _build.call("tj_compact_count", cnt.device, cnt.data_ptr(), n,
                counts.data_ptr())
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    excl = incl - counts
    _build.call("tj_compact_scatter", cnt.device, lo.data_ptr(),
                cnt.data_ptr(), sid.data_ptr(), n, excl.data_ptr(),
                incl[-1:].data_ptr(), *(o.data_ptr() for o in outs), k_cap)
    LAUNCHES += 1
    return tuple(outs)
