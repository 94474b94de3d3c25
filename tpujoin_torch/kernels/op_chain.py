"""The op-chain probe (csrc/roll_cost.cu): ``ops`` chained ops of one kind
on one (R, 128) int32 tile.

The port of exp/roll_cost.py's ``run`` (:52, kernel ``_mk_kernel`` :29),
which times a dependent chain of one Mosaic vector op. The kinds, with
jnp.roll's convention (out[i] = x[(i - s) mod n]):

  roll_lane     roll each row by ``sh`` along its 128 lanes
  roll_sub      roll the rows by ``sh``
  roll_static   roll the rows by 3
  concat_shift  rotate the rows down by one (the last row first)
  select        x + 1 where lane < ``sh``
  iota_add      x + lane

The result is the op applied ``ops`` times, adds wrapping. The JAX ``OPS``
(64) and ``NSTEP`` (512) are the defaults of ``ops`` and ``steps``. The
kernel runs ``steps`` repetitions of the chain, each from the same staged
tile, as each TPU grid step starts from the same VMEM block; every
repetition computes the same tile, so :func:`op_chain_plain` runs the
chain once. R is one of ROWS: the kernel holds the tile in registers,
one block of 1024 threads (512 for roll_lane at R = 16), and R = 512 as
two independent blocks; a roll is one warp shuffle an element an op. A
CUDA tensor goes through the kernel, a CPU tensor through the plain
version; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

LANES = 128
KINDS = ("roll_lane", "roll_sub", "roll_static", "concat_shift", "select",
         "iota_add")            # the order of Kind in csrc/roll_cost.cu
ROW_KINDS = ("roll_sub", "roll_static", "concat_shift")
ROWS = (16, 64, 256, 512)   # the program's
OPS = 64
STEPS = 512
IMIN, IMAX = -2**31, 2**31 - 1


def _check(x: torch.Tensor, sh: int, kind: str, ops: int, steps: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"op_chain: unknown kind {kind!r}; one of {KINDS}")
    if x.dim() != 2 or x.shape[1] != LANES or x.shape[0] not in ROWS:
        raise ValueError(f"op_chain: expected (R, {LANES}) with R in {ROWS}, "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise ValueError(f"op_chain: expected int32, got {x.dtype}")
    if not IMIN <= sh <= IMAX:
        raise ValueError(f"op_chain: shift {sh} is not an i32")
    if ops < 0 or steps < 1:
        raise ValueError(f"op_chain: ops {ops} < 0 or steps {steps} < 1")


def op_chain_plain(x: torch.Tensor, sh: int, kind: str, ops: int = OPS,
                   steps: int = STEPS) -> torch.Tensor:
    """The ops one by one with torch.roll and torch.where, once."""
    _check(x, sh, kind, ops, steps)
    lane = torch.arange(LANES, dtype=torch.int32, device=x.device)
    out = x.clone()
    for _ in range(ops):
        if kind == "roll_lane":
            out = torch.roll(out, sh, 1)
        elif kind == "roll_sub":
            out = torch.roll(out, sh, 0)
        elif kind == "roll_static":
            out = torch.roll(out, 3, 0)
        elif kind == "concat_shift":
            out = torch.cat([out[-1:], out[:-1]])
        elif kind == "select":
            out = torch.where(lane < sh, out + 1, out)
        else:
            out = out + lane
    return out


def op_chain(x: torch.Tensor, sh: int, kind: str, ops: int = OPS,
             steps: int = STEPS) -> torch.Tensor:
    """``kind`` applied ``ops`` times to the (R, 128) int32 tile ``x``,
    the chain run ``steps`` times on the card."""
    _check(x, sh, kind, ops, steps)
    if _build.on_cpu(x):
        return op_chain_plain(x, sh, kind, ops, steps)
    if not x.is_contiguous():
        raise ValueError("op_chain: x must be contiguous")
    out = torch.empty_like(x)
    _build.check_cuda_i32(x.view(-1), out.view(-1))
    _build.call("tj_op_chain", x.device, x.data_ptr(), out.data_ptr(),
                x.shape[0], KINDS.index(kind), sh, ops, steps)
    return out
