"""The second Mosaic capability probe's two kernels
(csrc/probe_mosaic2.cu): a bulk copy to shared memory at a run-time offset,
and a load from a run-time start.

The port of exp/probe_mosaic2.py's ``t_hbm_to_smem`` (:33) and
``t_dyn_vec_load`` (:54), at their shapes, all int32, one block each.
``hbm_to_smem`` moves its window with a TMA bulk copy that completes on an
mbarrier (csrc/tma.cuh), as the TPU kernel moves it with a DMA and a
semaphore. Precondition for the TPU kernels' result: the copy's offset is a
multiple of 4 words in [0, 8192 - 2048], and ``dyn_vec_load``'s start lies
in [0, 4096 - 1024]. Outside it the result is defined too, and the plain
version gives the same values: a word outside x reads 0. The wrapper
refuses an ``x`` whose data is not 16-byte aligned (a bulk copy's source
must be). A CUDA tensor goes through the kernel, a CPU tensor through the
``*_plain`` version beside it; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build
from tpujoin_torch.kernels.mosaic import LANES, broadcast_row, read_or_zero

HS_N = 8192         # x of hbm_to_smem
WINDOW = 2048       # HS_WINDOW: the copied window
DV_N = 4096         # x of dyn_vec_load
DV_OUT = 1024       # its output row


def hbm_to_smem_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x[s[0] + s[1]] where s[1] lies in [0, WINDOW) and the sum in x,
    else 0, in int64 on the device (no host read)."""
    _build.check_shapes("hbm_to_smem", (x, (HS_N,)), (s, (2,)))
    idx = s[1].long()
    v = read_or_zero(x, s[0].long() + idx)
    return broadcast_row(torch.where((idx >= 0) & (idx < WINDOW), v, 0))


def hbm_to_smem(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Word s[1] of the WINDOW-word window of the 8192-word x at offset
    s[0], copied into shared memory first, broadcast to (1, 128).

    Precondition for the TPU kernel's result: s[0] is a multiple of 4 in
    [0, 6144] and s[1] in [0, 2048); the result is then x[s[0] + s[1]].
    For every other pair it is x[s[0] + s[1]] where s[1] lies in [0, 2048)
    and s[0] + s[1] in x, else 0: the kernel clamps the copy to x and
    rounds its ends out to 16 bytes. x's data must be 16-byte aligned."""
    _build.check_shapes("hbm_to_smem", (x, (HS_N,)), (s, (2,)))
    if _build.on_cpu(x, s):
        return hbm_to_smem_plain(x, s)
    _build.check_aligned(x)
    return _build.launch("tj_mosaic_hbm_to_smem", (1, LANES), x, s)


def dyn_vec_load_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _build.check_shapes("dyn_vec_load", (x, (1, DV_N)), (s, (1,)))
    g = torch.arange(DV_OUT, device=x.device) + s[0].long()
    ok = (g >= 0) & (g < DV_N)
    return torch.where(ok, x[0, g.clamp(0, DV_N - 1)], 0).view(1, DV_OUT)


def dyn_vec_load(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x[0, s[0] : s[0] + 1024] of the (1, 4096) x, as (1, 1024).

    Precondition for the TPU kernel's result: s[0] in [0, 3072]. Words
    outside x read 0, for every i32 s[0]."""
    _build.check_shapes("dyn_vec_load", (x, (1, DV_N)), (s, (1,)))
    if _build.on_cpu(x, s):
        return dyn_vec_load_plain(x, s)
    return _build.launch("tj_mosaic_dyn_vec_load", (1, DV_OUT), x, s)
