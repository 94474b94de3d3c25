"""The single-pass scan probe (csrc/bench_mat2.cu): the inclusive prefix sum
of i32 mod 2^32.

The port of exp/bench_mat2.py's ``pallas_scan``: the TPU kernel scans each
65,536-row block and passes a carry from grid step to grid step; the
Hopper kernel scans tiles of TILE rows in parallel and passes the carry by
a decoupled look-back over per-tile status words. The TPU kernel took n as
a multiple of its block; this one takes any n. A CUDA tensor goes through
the kernel, a CPU tensor through :func:`carry_scan_plain`; anything else
raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build
from tpujoin_torch.utils.shapes import cdiv

LAUNCHES = 0
TILE = 8192            # rows a block scans: SCAN_TILE in csrc/bench_mat2.cu


def carry_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """The int64 cumsum, wrapped to i32 explicitly: the low 32 bits as a
    signed value (no i32 overflow is relied on)."""
    c = torch.cumsum(x, 0, dtype=torch.int64)
    return c.add_(2**31).bitwise_and_(2**32 - 1).sub_(2**31).to(torch.int32)


def carry_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D int32 tensor, mod 2^32."""
    global LAUNCHES
    if _build.on_cpu(x):
        return carry_scan_plain(x)
    _build.check_cuda_i32(x)
    y = torch.empty_like(x)
    n = x.shape[0]
    if n:
        # the tiles' status words and the ticket, zeroed by the entry point
        words = cdiv(n, TILE) + 1
        scratch = torch.empty(words, dtype=torch.int64, device=x.device)
        _build.call("tj_carry_scan", x.device, x.data_ptr(), y.data_ptr(), n,
                    scratch.data_ptr(), words)
        LAUNCHES += 1
    return y
