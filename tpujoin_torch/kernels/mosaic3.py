"""The third Mosaic capability probe's three kernels
(csrc/probe_mosaic3.cu), on (R, 128) int32 tiles: a roll of the rows, a
2-D copy of rows at a run-time offset, and a flat rotate.

The port of exp/probe_mosaic3.py's ``t_sublane_roll`` (:33),
``t_2d_row_dma`` (:55) and ``t_flat_rotate`` (:86), at their shapes, one
block each. ``row_dma_2d``, a DMA and a semaphore on the TPU, is a direct
load here: each thread reads the run-time row from ``s`` and moves one
16-byte word of its row. The rolls are defined for every i32 shift.
``row_dma_2d``'s precondition for the TPU kernel's result: the row lies in
[0, 256 - 32]; outside it, rows outside x are 0, and the plain version
gives the same values. The wrapper refuses an ``x`` whose data is not
16-byte aligned, as its 16-byte loads need. A CUDA tensor goes through
the kernel, a CPU tensor through the ``*_plain`` version beside it;
anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

LANES = 128         # TL_LANES: a row of every tile
SR_ROWS = 32        # sublane_roll's tile
RD_X_ROWS = 256     # row_dma_2d's x
RD_ROWS = 32        # its output
FR_ROWS = 32        # flat_rotate's x
FR_OUT_ROWS = 8     # its output


def sublane_roll_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _build.check_shapes("sublane_roll", (x, (SR_ROWS, LANES)), (s, (1,)))
    r = torch.arange(SR_ROWS, device=x.device)
    return x[(r + s[0].long()) & (SR_ROWS - 1)]


def sublane_roll(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[r] = x[(r + s[0]) mod 32] of the (32, 128) x: its rows rolled
    by -s[0], for every i32 s[0]."""
    _build.check_shapes("sublane_roll", (x, (SR_ROWS, LANES)), (s, (1,)))
    if _build.on_cpu(x, s):
        return sublane_roll_plain(x, s)
    return _build.launch("tj_mosaic_sublane_roll", (SR_ROWS, LANES), x, s)


def row_dma_2d_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _build.check_shapes("row_dma_2d", (x, (RD_X_ROWS, LANES)), (s, (1,)))
    r = torch.arange(RD_ROWS, device=x.device) + s[0].long()
    ok = ((r >= 0) & (r < RD_X_ROWS)).view(-1, 1)
    return torch.where(ok, x[r.clamp(0, RD_X_ROWS - 1)], 0)


def row_dma_2d(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rows s[0] .. s[0] + 31 of the (256, 128) x, as (32, 128).

    Precondition for the TPU kernel's result: s[0] in [0, 224] (a multiple
    of 8 there). Rows outside x are 0, for every i32 s[0]. x's data must be
    16-byte aligned."""
    _build.check_shapes("row_dma_2d", (x, (RD_X_ROWS, LANES)), (s, (1,)))
    if _build.on_cpu(x, s):
        return row_dma_2d_plain(x, s)
    _build.check_aligned(x)
    return _build.launch("tj_mosaic_row_dma_2d", (RD_ROWS, LANES), x, s)


def flat_rotate_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _build.check_shapes("flat_rotate", (x, (FR_ROWS, LANES)), (s, (1,)))
    flat = FR_ROWS * LANES
    u = torch.arange(FR_OUT_ROWS * LANES, device=x.device)
    return x.view(-1)[(u + s[0].long()) & (flat - 1)].view(FR_OUT_ROWS,
                                                            LANES)


def flat_rotate(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[u] = flat[(u + s[0]) mod 4096] for the first 1024 words u of
    the row-major flat (32, 128) x, as (8, 128), for every i32 s[0].

    The TPU kernel builds it from two row rolls by s[0] // 128 (a floor),
    a lane roll by rem(s[0], 128) (a truncation) and a select; it agrees
    with this for s[0] >= 0 and for multiples of 128 only."""
    _build.check_shapes("flat_rotate", (x, (FR_ROWS, LANES)), (s, (1,)))
    if _build.on_cpu(x, s):
        return flat_rotate_plain(x, s)
    return _build.launch("tj_mosaic_flat_rotate", (FR_OUT_ROWS, LANES), x, s)
