"""Merge count: K2 (csrc/merge_count.cu), the hot half of the count phase.

The port of tpujoin/kernels/merge_count.py: for every sorted probe key, its
lower bound ``lo`` in the sorted build keys and its number of equal build
keys ``cnt``, both int32. A CUDA tensor goes through the kernel, a CPU
tensor through :func:`merge_count_plain`; anything else raises.

On the card one call is two launches: a co-rank pass that cuts the merged
order of the two columns into TILE-key tiles, into a scratch the wrapper
allocates, and the count kernel, which merges each tile in shared memory.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

TILE = 4096             # path elements of one tile (TILE in the .cu)


def merge_count_plain(sorted_build_keys: torch.Tensor,
                      sorted_probe_keys: torch.Tensor):
    """Two searchsorted calls, left and right."""
    lo = torch.searchsorted(sorted_build_keys, sorted_probe_keys,
                            out_int32=True)
    hi = torch.searchsorted(sorted_build_keys, sorted_probe_keys,
                            right=True, out_int32=True)
    return lo, hi - lo


def merge_count(sorted_build_keys: torch.Tensor,
                sorted_probe_keys: torch.Tensor):
    """(lo, cnt) for every probe key. Both inputs must be ascending."""
    b, p = sorted_build_keys, sorted_probe_keys
    if _build.on_cpu(b, p):
        return merge_count_plain(b, p)
    lo, cnt = torch.empty_like(p), torch.empty_like(p)
    _build.check_cuda_i32(b, p, lo, cnt)
    n, m = b.shape[0], p.shape[0]
    if n >= 2**31:
        raise ValueError("merge_count: more than 2^31 - 1 build keys")
    if m:
        rows = -(-(n + m) // TILE) + 1     # one per tile boundary
        parts = torch.empty(2 * rows, dtype=torch.int32, device=p.device)
        _build.call("tj_merge_count", p.device, b.data_ptr(), n,
                    p.data_ptr(), m, lo.data_ptr(), cnt.data_ptr(),
                    parts.data_ptr(), rows)
    return lo, cnt
