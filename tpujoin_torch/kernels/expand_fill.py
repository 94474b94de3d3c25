"""Fill expansion: K5 (csrc/expand_pairs.cu), the high-selectivity pair step.

The port of tpujoin/kernels/expand_fill.py: the pair columns of the
factorized join result. Runs are the compacted probe rows (output offset
``roff``, probe id ``rsid``); groups are the runs that share one build
slice (output offset ``goff``, slice start ``glo`` and length ``gnb`` in
``src``, the sorted build ids). For each output slot t below the total, in
run r and group g, the pair is (src[glo[g] + (t - goff[g]) mod gnb[g]],
rsid[r]); both columns are -1 from the total on. A CUDA tensor goes through
the kernel, a CPU tensor through :func:`expand_fill_plain`; anything else
raises. The TPU kernel's ``fits`` flag is gone: this kernel has no
envelope.

On the card one call is two launches: a partition pass that finds each
TILE-slot tile's first run and group, into a scratch the wrapper
allocates (:func:`partition_scratch`), and the fill kernel, which walks
each tile from a shared-memory window of its runs and groups.
"""
from __future__ import annotations

import math

import torch

from tpujoin_torch.kernels import _build

PLAIN_CHUNK = 1 << 26   # slots per step of the plain versions
TILE = 2048             # slots of one K5 window (TILE in the .cu)


def check_sizes(name: str, counted, total: int, capacity: int) -> None:
    """Raise unless each (rows, width) pair of ``counted`` has
    0 <= rows <= width, the total is an i32 slot count and capacity >= 0."""
    for rows, width in counted:
        if not 0 <= rows <= width:
            raise ValueError(f"{name}: {rows} real rows of {width}")
    if not 0 <= total < 2**31:
        raise ValueError(f"{name}: total {total} is not an i32 slot count")
    if capacity < 0:
        raise ValueError(f"{name}: capacity {capacity} < 0")


def take_or_neg(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] as int32, -1 where idx lies outside [0, len(src))."""
    n = src.shape[0]
    if n == 0:
        return torch.full_like(idx, -1, dtype=torch.int32)
    inside = (idx >= 0) & (idx < n)
    return torch.where(inside, src[idx.clamp(0, n - 1)], -1).to(torch.int32)


def slot_chunks(total: int, capacity: int, device):
    """-1-filled (r, s) columns of ``capacity`` slots, and the int64 slot
    indices below min(total, capacity) in steps of PLAIN_CHUNK, as
    (start, t) pairs."""
    r_out = torch.full((capacity,), -1, dtype=torch.int32, device=device)
    s_out = torch.full_like(r_out, -1)
    valid = min(total, capacity)
    steps = ((a, torch.arange(a, min(a + PLAIN_CHUNK, valid), device=device))
             for a in range(0, valid, PLAIN_CHUNK))
    return r_out, s_out, steps


def expand_fill_plain(roff, rsid, goff, glo, gnb, src, nruns: int,
                      ngroups: int, total: int, capacity: int):
    """searchsorted of each slot in the run and group offsets, then
    gathers, PLAIN_CHUNK slots at a time."""
    r_out, s_out, steps = slot_chunks(total, capacity, roff.device)
    runs = roff[:nruns].long()
    heads = goff[:ngroups].long()
    for a, t in steps:
        b = a + t.shape[0]
        if nruns:
            r = torch.searchsorted(runs, t, right=True) - 1
            s_out[a:b] = torch.where(r >= 0, rsid[r.clamp(min=0)], -1)
        if ngroups:
            g = (torch.searchsorted(heads, t, right=True) - 1).clamp_(min=0)
            phase = torch.remainder(t - heads[g], gnb[g].clamp(min=1))
            r_out[a:b] = take_or_neg(src, glo[g].long() + phase)
    return r_out, s_out


def partition_scratch(total: int, capacity: int, device,
                      per_block: int = TILE):
    """The uninitialised scratch of K5's partition pass for ``per_block``
    slots a block, and its rows: two int32 columns of one row per
    gcd(per_block, TILE)-slot tile below min(total, capacity), and one
    more."""
    tile = math.gcd(per_block, TILE)
    rows = -(-max(min(total, capacity), 0) // tile) + 1
    return torch.empty(2 * rows, dtype=torch.int32, device=device), rows


def launch(name: str, roff, rsid, goff, glo, gnb, src, nruns, ngroups,
           total, capacity):
    """The checks and the launches of K5 (partition pass, fill kernel),
    shared by :func:`expand_fill` and ``expand_groups.expand_groups``.
    Returns (r_vals, s_ids)."""
    nruns, ngroups, total = int(nruns), int(ngroups), int(total)
    check_sizes(name, ((nruns, roff.shape[0]), (nruns, rsid.shape[0]),
                       (ngroups, goff.shape[0]), (ngroups, glo.shape[0]),
                       (ngroups, gnb.shape[0])), total, capacity)
    if _build.on_cpu(roff, rsid, goff, glo, gnb, src):
        return expand_fill_plain(roff, rsid, goff, glo, gnb, src, nruns,
                                 ngroups, total, capacity)
    r_vals = torch.empty(capacity, dtype=torch.int32, device=roff.device)
    s_ids = torch.empty_like(r_vals)
    _build.check_cuda_i32(roff, rsid, goff, glo, gnb, src, r_vals, s_ids)
    if capacity == 0:
        return r_vals, s_ids
    parts, rows = partition_scratch(total, capacity, r_vals.device)
    _build.call("tj_expand_fill", r_vals.device, roff.data_ptr(),
                rsid.data_ptr(), nruns, goff.data_ptr(), glo.data_ptr(),
                gnb.data_ptr(), ngroups, src.data_ptr(), src.shape[0], total,
                r_vals.data_ptr(), s_ids.data_ptr(), capacity,
                parts.data_ptr(), rows)
    return r_vals, s_ids


def expand_fill(roff: torch.Tensor, rsid: torch.Tensor, goff: torch.Tensor,
                glo: torch.Tensor, gnb: torch.Tensor, src: torch.Tensor,
                nruns: int, ngroups: int, total: int, capacity: int):
    """(r_vals, s_ids), each [capacity] int32. The first ``nruns`` rows of
    ``roff`` are strictly increasing, as are the first ``ngroups`` of
    ``goff``; only those rows are read."""
    return launch("expand_fill", roff, rsid, goff, glo, gnb, src, nruns,
                  ngroups, total, capacity)
