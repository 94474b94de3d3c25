"""The shift-loop probe (csrc/bench_mat2.cu): a per-tile shift-select loop.

The port of exp/bench_mat2.py's ``rollloop``, which models the per-op cost
of a data-dependent shift. Within each TILE-row tile, for d in
[0, rolls): ``acc[l] = x[l - d] if l >= d else acc[l]``, from acc = 0, so
``out[l] = x[max(0, l - (rolls - 1))]`` for rolls >= 1 and 0 for
rolls = 0. The kernel runs the loop; :func:`shift_loop_plain` uses the
closed form. n must be a multiple of TILE: the TPU kernel leaves a partial
tile unwritten, and this port refuses one. A CUDA tensor goes through the
kernel, a CPU tensor through the plain version; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

LAUNCHES = 0
TILE = 1024            # SHIFT_TILE in csrc/bench_mat2.cu


def _check(x: torch.Tensor, rolls: int) -> None:
    if x.shape[0] % TILE:
        raise ValueError(f"shift_loop: {x.shape[0]} rows is not a multiple "
                         f"of the {TILE}-row tile")
    if rolls < 0:
        raise ValueError(f"shift_loop: rolls {rolls} < 0")


def shift_loop_plain(x: torch.Tensor, rolls: int) -> torch.Tensor:
    """The loop's closed form, one gather per tile."""
    _check(x, rolls)
    if rolls == 0:
        return torch.zeros_like(x)
    lane = torch.arange(TILE, device=x.device)
    src = (lane - (rolls - 1)).clamp_min(0)
    return x.view(-1, TILE)[:, src].reshape(-1)


def shift_loop(x: torch.Tensor, rolls: int) -> torch.Tensor:
    """The shift-select loop over each TILE-row tile of a 1-D int32
    tensor, ``rolls`` times."""
    global LAUNCHES
    _check(x, rolls)
    if _build.on_cpu(x):
        return shift_loop_plain(x, rolls)
    _build.check_cuda_i32(x)
    out = torch.empty_like(x)
    if x.shape[0]:
        _build.call("tj_shift_loop", x.device, x.data_ptr(), out.data_ptr(),
                    x.shape[0], rolls)
        LAUNCHES += 1
    return out
