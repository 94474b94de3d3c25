"""(key, id) merge sort: K1, block sort + merge passes (csrc/merge_sort.cu).

The port of tpujoin/kernels/merge_sort.py. :func:`block_sort` sorts each
``TILE``-pair tile into an ascending run; :func:`merge_pass` merges adjacent
runs of length ``run`` into runs of ``2 * run``; :func:`sort_pairs` chains
them, ping-ponging between two buffer pairs. Any n sorts, with every i32
key: the ragged last tile and run are handled by bounds, not by pad keys.

Both kernels are stable, so the sort is: ties keep their input order. The
plain versions are stable sorts of each tile or run pair (a stable sort of
two ascending runs is their A-first merge), so kernel and plain version
agree bitwise on keys and ids.

A CUDA tensor goes through the kernels, a CPU tensor through the plain
versions; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

TILE = 2048             # pairs per block-sorted run (SORT_TILE in the .cu)
LAUNCHES = 0            # block-sort kernel launches
MERGE_LAUNCHES = 0      # merge-pass kernel launches


def segment_sort_plain(keys: torch.Tensor, ids: torch.Tensor, seg: int):
    """Stable sort of each ``seg``-long segment of (keys, ids), the last
    one ragged: the plain version of both kernels."""
    n = keys.shape[0]
    full = (n // seg) * seg
    ko, io = torch.empty_like(keys), torch.empty_like(ids)
    parts = [(0, full, seg)] if full else []
    if n > full:
        parts.append((full, n, n - full))
    for lo, hi, width in parts:
        k2 = keys[lo:hi].view(-1, width)
        sk, order = torch.sort(k2, dim=1, stable=True)
        ko[lo:hi] = sk.reshape(-1)
        io[lo:hi] = torch.gather(ids[lo:hi].view(-1, width), 1,
                                 order).reshape(-1)
    return ko, io


def _outputs(keys: torch.Tensor, ids: torch.Tensor,
             out: tuple[torch.Tensor, torch.Tensor] | None):
    """The (keys, ids) output pair of a kernel, allocated unless given,
    after checking inputs and outputs alike."""
    ko, io = out if out is not None else (torch.empty_like(keys),
                                          torch.empty_like(ids))
    _build.check_cuda_i32(keys, ids, ko, io)
    n = keys.shape[0]
    if ids.shape[0] != n or ko.shape[0] != n or io.shape[0] != n:
        raise ValueError("keys, ids and outputs differ in length")
    return ko, io


def block_sort(keys: torch.Tensor, ids: torch.Tensor,
               out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Sort each TILE-long tile of (keys, ids) into an ascending run."""
    global LAUNCHES
    if _build.on_cpu(keys, ids):
        return segment_sort_plain(keys, ids, TILE)
    ko, io = _outputs(keys, ids, out)
    n = keys.shape[0]
    if n:
        _build.call("tj_block_sort", keys.device, keys.data_ptr(),
                    ids.data_ptr(), ko.data_ptr(), io.data_ptr(), n)
        LAUNCHES += 1
    return ko, io


def merge_pass(keys: torch.Tensor, ids: torch.Tensor, run: int,
               out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Merge adjacent ascending runs of length ``run`` (a multiple of TILE;
    the last run may be short) into ascending runs of ``2 * run``."""
    global MERGE_LAUNCHES
    if run <= 0 or run % TILE:
        raise ValueError(f"merge_pass: run {run} is not a multiple of {TILE}")
    if _build.on_cpu(keys, ids):
        return segment_sort_plain(keys, ids, 2 * run)
    ko, io = _outputs(keys, ids, out)
    n = keys.shape[0]
    if n:
        _build.call("tj_merge_pass", keys.device, keys.data_ptr(),
                    ids.data_ptr(), ko.data_ptr(), io.data_ptr(), n, run)
        MERGE_LAUNCHES += 1
    return ko, io


def sort_pairs(keys: torch.Tensor, ids: torch.Tensor):
    """Stable ascending sort of (key i32, id i32) pairs of any length:
    one block sort, then ceil(log2(n / TILE)) merge passes between two
    buffer pairs. The inputs are left as they are. On CPU tensors it is
    :func:`sort_pairs_plain`, which gives the same answer."""
    if _build.on_cpu(keys, ids):
        return sort_pairs_plain(keys, ids)
    n = keys.shape[0]
    bufs = [(torch.empty_like(keys), torch.empty_like(ids)) for _ in range(2)]
    k, i = block_sort(keys, ids, out=bufs[0])
    run, cur = TILE, 0
    while run < n:
        cur ^= 1
        k, i = merge_pass(k, i, run, out=bufs[cur])
        run *= 2
    return k, i


def sort_pairs_plain(keys: torch.Tensor, ids: torch.Tensor):
    """The plain version of :func:`sort_pairs`: torch.sort + gather."""
    sk, order = torch.sort(keys, stable=True)
    return sk, ids[order]
