"""Slab count: K2's slab design probe (csrc/count_variants.cu).

The port of exp/count_variants.py:119 ``merge_count_v``: for every sorted
probe key, ``min(lo, n)`` and ``cnt``, lo the number of build keys below
the key and cnt the number equal to it, both int32. Every strategy returns
the same answer; they differ in which slabs of build keys the kernel
resolves (by a search in shared memory) and which it adds or skips whole:

  fat512   the whole tile as one probe piece, 512-key slabs, no slab skip
  fatcN    the whole tile as one probe piece, N-key slabs, slab skip
  diagN    128-key probe pieces, N-key slabs, slab skip
  quadN    as diagN (the JAX program parses quad256 to 256-key slabs)

Keys must be below INT32_MAX, the pad key. Where the JAX kernel clamps its
window start to ``n_pad - 1024`` (``:136``) and so returns ``n - 1024``
for a whole tile above every build key when n is a multiple of 1024, this
returns the lower bound n. A CUDA tensor goes through the kernel, a CPU
tensor through :func:`merge_count_v_plain`; anything else raises, as does
an unknown strategy. A call is two launches, a window pass and the count,
and counts one in ``trace.launches["tj_slab_count"]``.
"""
from __future__ import annotations

import re

import torch

from tpujoin_torch.kernels import _build

TILE = 1024                # probe keys a block takes: the JAX program's
WARP_PIECE = 128           # the diagN / quadN probe piece
CHUNK = 1024               # build keys a block stages at a time

_STRATEGY = re.compile(r"(fat512|fatc|diag|quad)(\d*)")


def parse_strategy(strategy: str):
    """(piece, slab, skip_slabs) of a strategy name; raises on a name the
    JAX program does not parse or on a slab that does not divide CHUNK."""
    match = _STRATEGY.fullmatch(strategy)
    if match is None or (match[1] == "fat512") == bool(match[2]):
        raise ValueError(f"merge_count_v: unknown strategy {strategy!r}")
    if match[1] == "fat512":
        piece, slab, skip = TILE, 512, False
    else:
        piece, slab, skip = (TILE if match[1] == "fatc" else WARP_PIECE,
                             int(match[2]), True)
    if not 4 <= slab <= CHUNK or slab & (slab - 1):
        raise ValueError(f"merge_count_v: slab {slab} of {strategy!r} is not "
                         f"a power of two in [4, {CHUNK}]")
    return piece, slab, skip


def merge_count_v_plain(sorted_build_keys: torch.Tensor,
                        sorted_probe_keys: torch.Tensor):
    """Two searchsorted calls, left and right."""
    b, p = sorted_build_keys, sorted_probe_keys
    lo = torch.searchsorted(b, p, out_int32=True)
    hi = torch.searchsorted(b, p, right=True, out_int32=True)
    return lo, hi - lo


def merge_count_v(sorted_build_keys: torch.Tensor,
                  sorted_probe_keys: torch.Tensor, strategy: str):
    """(lo, cnt) for every probe key by ``strategy``, TILE probe keys a
    block. Both inputs must be ascending and below INT32_MAX."""
    piece, slab, skip = parse_strategy(strategy)
    b, p = sorted_build_keys, sorted_probe_keys
    if _build.on_cpu(b, p):
        return merge_count_v_plain(b, p)
    lo, cnt = torch.empty_like(p), torch.empty_like(p)
    _build.check_cuda_i32(b, p, lo, cnt)
    if b.shape[0] >= 2**31:
        raise ValueError("merge_count_v: more than 2^31 - 1 build keys")
    if p.shape[0]:
        tiles = -(-p.shape[0] // TILE)
        window = torch.empty(2 * tiles, dtype=torch.int32, device=p.device)
        _build.call("tj_slab_count", p.device, b.data_ptr(), b.shape[0],
                    p.data_ptr(), p.shape[0], int(piece < TILE), slab,
                    int(skip), window.data_ptr(), tiles, lo.data_ptr(),
                    cnt.data_ptr())
    return lo, cnt
