"""The Mosaic capability probe's five kernels (csrc/probe_mosaic.cu): each
reads a scalar at run time and uses it as a shift, an index or a loop bound.

The port of exp/probe_mosaic.py's ``t_roll`` (:43), ``t_smem_dyn`` (:62),
``t_vmem_dyn`` (:80), ``t_fori`` (:104) and ``t_smem_block`` (:122), at
their shapes, all int32, one block each. Every scalar is defined for every
i32 value: a roll is taken mod its length, an index outside its input reads
0, and a loop bound <= 0 runs no iteration. Inside the TPU kernels' domain
(an index inside its input) each equals its TPU kernel. A CUDA tensor goes
through the kernel, a CPU tensor through the ``*_plain`` version beside it;
anything else raises. Each kernel has its own launch counter.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build
from tpujoin_torch.kernels.runs_phases import wrap_i32

ROW = 1024          # PM_ROW: x's (1, ROW) row of roll and vmem_dyn
LANES = 128         # PM_LANES: the (1, LANES) outputs
S_WORDS = 5         # PM_S: smem_dyn's s
META = 4096         # PM_META: smem_block's meta
BLOCK = 1024        # PM_BLOCK: its block


def broadcast_row(v: torch.Tensor) -> torch.Tensor:
    """The one-element ``v`` as a (1, LANES) row."""
    return v.view(1, 1).expand(1, LANES).contiguous()


def read_or_zero(col: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """col[i] for the 0-d int64 ``i``, 0 outside col, as one element. The
    index is a one-element tensor: PyTorch reads a 0-d index on the host,
    which would wait on the device."""
    n = col.shape[0]
    i = i.view(1)
    return torch.where((i >= 0) & (i < n), col[i.clamp(0, n - 1)], 0)


def roll_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """A gather at (i + s) & (ROW - 1) in int64, the shift kept on the
    device (torch.roll would need it on the host)."""
    _build.check_shapes("roll", (x, (1, ROW)), (s, (1,)))
    i = torch.arange(ROW, device=x.device)
    return x[:, (i + s[0].long()) & (ROW - 1)]


def roll(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[0, i] = x[0, (i + s[0]) mod 1024]: the (1, 1024) row rolled by
    -s[0], for every i32 s[0]."""
    _build.check_shapes("roll", (x, (1, ROW)), (s, (1,)))
    if _build.on_cpu(x, s):
        return roll_plain(x, s)
    return _build.launch("tj_mosaic_roll", (1, ROW), x, s)


def smem_dyn_plain(s: torch.Tensor) -> torch.Tensor:
    _build.check_shapes("smem_dyn", (s, (S_WORDS,)))
    return broadcast_row(read_or_zero(s, s[0].long()))


def smem_dyn(s: torch.Tensor) -> torch.Tensor:
    """s[s[0]] of the 5-word s broadcast to (1, 128); 0 where s[0] lies
    outside [0, 5)."""
    _build.check_shapes("smem_dyn", (s, (S_WORDS,)))
    if _build.on_cpu(s):
        return smem_dyn_plain(s)
    return _build.launch("tj_mosaic_smem_dyn", (1, LANES), s)


def vmem_dyn_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _build.check_shapes("vmem_dyn", (x, (1, ROW)), (s, (1,)))
    return broadcast_row(read_or_zero(x[0], s[0].long()))


def vmem_dyn(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x[0, s[0]] of the (1, 1024) x broadcast to (1, 128); 0 where s[0]
    lies outside [0, 1024)."""
    _build.check_shapes("vmem_dyn", (x, (1, ROW)), (s, (1,)))
    if _build.on_cpu(x, s):
        return vmem_dyn_plain(x, s)
    return _build.launch("tj_mosaic_vmem_dyn", (1, LANES), x, s)


def fori_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The closed form n * x + n (n - 1) / 2 with n = max(s[0], 0), exact
    in int64 (below 2^63 for every i32 pair), wrapped to i32."""
    _build.check_shapes("fori", (x, (1, LANES)), (s, (1,)))
    n = s[0].long().clamp(min=0)
    return wrap_i32(n * x.long() + n * (n - 1) // 2).to(torch.int32)


def fori(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """sum over d < s[0] of (x + d) on the (1, 128) x, adds wrapping: a
    loop whose bound is read at run time (s[0] <= 0 runs none). The kernel
    runs s[0] dependent adds: ~2^31 of them take seconds."""
    _build.check_shapes("fori", (x, (1, LANES)), (s, (1,)))
    if _build.on_cpu(x, s):
        return fori_plain(x, s)
    return _build.launch("tj_mosaic_fori", (1, LANES), x, s)


def smem_block_plain(meta: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    _build.check_shapes("smem_block", (meta, (META,)), (r, (1,)))
    return broadcast_row(read_or_zero(meta, r[0].long() * BLOCK))


def smem_block(meta: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Element 0 of block r[0] of 1024 of the 4096-word meta, broadcast to
    (1, 128); 0 where r[0] lies outside [0, 4)."""
    _build.check_shapes("smem_block", (meta, (META,)), (r, (1,)))
    if _build.on_cpu(meta, r):
        return smem_block_plain(meta, r)
    return _build.launch("tj_mosaic_smem_block", (1, LANES), meta, r)
