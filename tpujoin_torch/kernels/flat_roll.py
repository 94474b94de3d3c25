"""The flat-roll probe (csrc/probe_flatroll.cu): a sum of flat rolls of
each 1024-element tile.

The port of exp/probe_flatroll.py's ``run`` (:58, kernel ``_kernel`` :42,
``flat_roll`` :33). Each 1024-element tile t of the column (the TPU's
(8, 128) tile, row-major) becomes sum over d < ``rolls`` of
t[(f - shifts[d]) mod 1024], adds wrapping: np.roll of the flat tile by
each shift. The roll is defined for every i32 shift. The JAX
``flat_roll`` agrees with it for shifts >= 0 only: it takes k // 128 (a
floor) beside rem(k, 128) (a truncation), so k = -1 gives a tile starting
[129, 130, ...] where np.roll gives [1, 2, ...]. The length must be a
multiple of STEP, the TPU kernel's grid step of 8 tiles; others are
refused. A CUDA tensor goes through the kernel, a CPU tensor through
:func:`flat_roll_plain`; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

TILE = 1024                  # FR_TILE in csrc/probe_flatroll.cu
STEP = 8 * TILE              # the TPU kernel's grid step (BATCH tiles)
MAX_SHIFTS = 8192            # FR_MAX_SHIFTS in csrc/probe_flatroll.cu


def _check(x: torch.Tensor, shifts: torch.Tensor, rolls: int) -> None:
    if x.dim() != 1 or shifts.dim() != 1:
        raise ValueError("flat_roll: x and shifts must be 1-D")
    if x.dtype != torch.int32 or shifts.dtype != torch.int32:
        raise ValueError(f"flat_roll: expected int32, got {x.dtype} and "
                         f"{shifts.dtype}")
    if x.shape[0] % STEP:
        raise ValueError(f"flat_roll: {x.shape[0]} elements is not a "
                         f"multiple of the {STEP}-element step")
    if not 0 <= rolls <= min(shifts.shape[0], MAX_SHIFTS):
        raise ValueError(f"flat_roll: rolls {rolls} outside [0, "
                         f"{min(shifts.shape[0], MAX_SHIFTS)}]")


def flat_roll_plain(x: torch.Tensor, shifts: torch.Tensor,
                    rolls: int) -> torch.Tensor:
    """A loop over d of one gather per tile, the roll's source index
    computed from the shift on the device (torch.roll would need it on
    the host)."""
    _check(x, shifts, rolls)
    tiles = x.view(-1, TILE)
    f = torch.arange(TILE, device=x.device)
    acc = torch.zeros_like(tiles)
    for d in range(rolls):
        acc += tiles[:, (f - shifts[d]) & (TILE - 1)]
    return acc.reshape(-1)


def flat_roll(x: torch.Tensor, shifts: torch.Tensor,
              rolls: int) -> torch.Tensor:
    """The sum of ``rolls`` flat rolls of each TILE-element tile of the
    1-D int32 column ``x``, by the first ``rolls`` of ``shifts``."""
    _check(x, shifts, rolls)
    if _build.on_cpu(x, shifts):
        return flat_roll_plain(x, shifts, rolls)
    _build.check_cuda_i32(x, shifts)
    out = torch.empty_like(x)
    if x.shape[0]:
        _build.call("tj_flat_roll", x.device, x.data_ptr(), out.data_ptr(),
                    x.shape[0], shifts.data_ptr(), rolls)
    return out
