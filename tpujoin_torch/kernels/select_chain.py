"""The per-op overhead probe (csrc/probe_opcost.cu): a chain of
compare-select-adds over each block of a column.

The port of exp/probe_opcost.py's ``run`` (:37, kernel ``_kernel`` :24).
The column is cut into blocks of ``rows`` * 128 elements (the TPU kernel's
(R, 128) block, row-major); u is an element's index in its block. From
acc = x, for d < ``ops``: ``acc = acc + c if u >= c else acc`` with
c = shifts[d], the compare signed and the adds wrapping. The length must be
a multiple of the block: the TPU kernel leaves a partial block unwritten,
and this port refuses one. A CUDA tensor goes through the kernel, a CPU
tensor through :func:`select_chain_plain`; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

LANES = 128
MAX_SHIFTS = 8192            # SC_MAX_SHIFTS in csrc/probe_opcost.cu


def _check(x: torch.Tensor, shifts: torch.Tensor, ops: int,
           rows: int) -> int:
    if x.dim() != 1 or shifts.dim() != 1:
        raise ValueError("select_chain: x and shifts must be 1-D")
    if x.dtype != torch.int32 or shifts.dtype != torch.int32:
        raise ValueError(f"select_chain: expected int32, got {x.dtype} and "
                         f"{shifts.dtype}")
    block = rows * LANES
    if rows < 1 or x.shape[0] % block:
        raise ValueError(f"select_chain: {x.shape[0]} elements is not a "
                         f"multiple of the {rows} x {LANES} block")
    if not 0 <= ops <= min(shifts.shape[0], MAX_SHIFTS):
        raise ValueError(f"select_chain: ops {ops} outside [0, "
                         f"{min(shifts.shape[0], MAX_SHIFTS)}]")
    return block


def select_chain_plain(x: torch.Tensor, shifts: torch.Tensor, ops: int,
                       rows: int) -> torch.Tensor:
    """A loop over d of torch.where on the (blocks, rows * 128) view."""
    block = _check(x, shifts, ops, rows)
    u = torch.arange(block, dtype=torch.int32, device=x.device)
    acc = x.view(-1, block).clone()
    for d in range(ops):
        c = shifts[d]
        acc = torch.where(u >= c, acc + c, acc)
    return acc.reshape(-1)


def select_chain(x: torch.Tensor, shifts: torch.Tensor, ops: int,
                 rows: int) -> torch.Tensor:
    """The chain over each ``rows`` * 128-element block of the 1-D int32
    column ``x``, with the first ``ops`` of ``shifts``."""
    _check(x, shifts, ops, rows)
    if _build.on_cpu(x, shifts):
        return select_chain_plain(x, shifts, ops, rows)
    _build.check_cuda_i32(x, shifts)
    if x.data_ptr() % 16:
        raise ValueError("select_chain: x must be 16-byte aligned")
    out = torch.empty_like(x)
    if x.shape[0]:
        _build.call("tj_select_chain", x.device, x.data_ptr(),
                    out.data_ptr(), x.shape[0], shifts.data_ptr(), ops, rows)
    return out
