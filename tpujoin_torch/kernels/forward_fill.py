"""Forward fill of a marker column (csrc/probe_fill.cu), and the marker
scatter in front of it.

The port of exp/probe_fill.py:61 ``fill_forward`` and :77
``scatter_markers``. ``scatter_markers`` writes each of the first
``nonzero`` runs' probe ids at its output offset into a column of ``cap``
slots, -1 elsewhere (torch ops, as it is XLA glue in JAX). ``fill_forward``
sets every slot t to the last marker ``mark[t'] >= 0`` with ``t' <= t``, or
-1 before the first, across the whole column: the TPU kernel fills each
``step``-slot block and carries the last value from block to block; the
Hopper kernel is a single-pass scan with a decoupled look-back whose tile
is ``step``. Columns keep the JAX layout, (slots / 128, 128). A CUDA
tensor goes through the kernel, a CPU tensor through
:func:`fill_forward_plain`; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

LANES = 128
SUB = 8192                  # slots a pass of the kernel: step's multiple
PLAIN_CHUNK = 1 << 26       # slots a step of the plain version


def scatter_markers(offs_c: torch.Tensor, sid_c: torch.Tensor, nonzero: int,
                    cap: int) -> torch.Tensor:
    """(cap / 128, 128) int32: sid_c[r] at slot offs_c[r] for r < nonzero,
    -1 elsewhere. Offsets at or past ``cap`` are dropped, as in JAX."""
    mark = torch.full((cap,), -1, dtype=torch.int32, device=offs_c.device)
    pos = offs_c[:nonzero].long()
    keep = pos < cap
    mark[pos[keep]] = sid_c[:nonzero][keep]
    return mark.reshape(cap // LANES, LANES)


def _check(mark2d: torch.Tensor, step: int) -> int:
    if mark2d.dim() != 2 or mark2d.shape[1] != LANES:
        raise ValueError(f"fill_forward: expected (rows, {LANES}), got "
                         f"{tuple(mark2d.shape)}")
    n = mark2d.numel()
    if step <= 0 or step % SUB or n % step:
        raise ValueError(f"fill_forward: step {step} must be a positive "
                         f"multiple of {SUB} dividing the {n} slots")
    return n


def fill_forward_plain(mark2d: torch.Tensor, step: int) -> torch.Tensor:
    """A running max of the marked slots' indices, then a gather;
    ``step`` only shapes the kernel. The running max is taken along rows
    of SUB slots (a cummax over one long row runs as one block on the
    card), then across the rows' last values, and carried from chunk to
    chunk; the slots are a multiple of SUB."""
    n = _check(mark2d, step)
    flat = mark2d.reshape(-1)
    out = torch.empty_like(flat)
    last = torch.tensor([-1], dtype=torch.int64, device=flat.device)
    for a in range(0, n, PLAIN_CHUNK):
        chunk = flat[a:a + PLAIN_CHUNK]
        idx = torch.arange(a, a + chunk.shape[0], device=flat.device)
        idx = torch.where(chunk >= 0, idx, -1).reshape(-1, SUB)
        idx = torch.cummax(idx, 1).values
        rows = torch.cummax(torch.cat([last, idx[:-1, -1]]), 0).values
        idx = torch.maximum(idx, rows[:, None]).reshape(-1)
        out[a:a + chunk.shape[0]] = torch.where(idx >= 0,
                                                flat[idx.clamp(min=0)], -1)
        last = idx[-1:]
    return out.reshape(mark2d.shape)


def fill_forward(mark2d: torch.Tensor, step: int) -> torch.Tensor:
    """The forward-filled column, (rows, 128) int32 like ``mark2d``;
    ``step`` is a multiple of SUB dividing its slots."""
    n = _check(mark2d, step)
    if _build.on_cpu(mark2d):
        return fill_forward_plain(mark2d, step)
    out = torch.empty_like(mark2d)
    flat, flat_out = mark2d.reshape(-1), out.reshape(-1)
    _build.check_cuda_i32(flat, flat_out)
    if flat.data_ptr() % 16 or flat_out.data_ptr() % 16:
        raise ValueError("fill_forward: columns must be 16-byte aligned")
    if n:
        words = n // step + 1
        scratch = torch.empty(words, dtype=torch.int64, device=flat.device)
        _build.call("tj_fill_forward", flat.device, flat.data_ptr(),
                    flat_out.data_ptr(), n, step, scratch.data_ptr(), words)
    return out
