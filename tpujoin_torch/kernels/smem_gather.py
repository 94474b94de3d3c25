"""The on-chip gather probe (csrc/primitives.cu): ``out[i] = tbl[idx[i]]``
with the table held in shared memory.

The port of bench/primitives.py's E6 kernel (``vmem_gather``, a
16,384-entry i32 table in VMEM and 65,536 i32 indices). Each block of 1024
threads stages the whole table and gathers one index a thread, so the
probe's 65,536 indices take 64 blocks. Every block re-reads the table from
L2; at this size that staging costs less than the parallelism it buys
(PERF.md section 6). A table larger than a block's shared memory is
refused; indices outside ``[0, len(tbl))`` are the caller's error, as in
the TPU kernel. A CUDA tensor goes through the kernel, a CPU tensor
through :func:`smem_gather_plain`; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build



def max_table_entries(device: torch.device) -> int:
    """The most i32 table entries one block's shared memory holds on the
    CUDA ``device``."""
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_block_optin // 4


def smem_gather_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tbl[idx]``."""
    return tbl[idx.long()]


def smem_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tbl[idx]`` for 1-D int32 ``tbl`` and ``idx``, the table staged in
    each block's shared memory."""
    if _build.on_cpu(tbl, idx):
        return smem_gather_plain(tbl, idx)
    _build.check_cuda_i32(tbl, idx)
    if tbl.shape[0] > max_table_entries(tbl.device):
        raise ValueError(f"smem_gather: a table of {tbl.shape[0]} entries "
                         f"does not fit one block's shared memory")
    out = torch.empty_like(idx)
    if idx.shape[0]:
        if tbl.shape[0] == 0:
            raise ValueError("smem_gather: indices into an empty table")
        _build.call("tj_smem_gather", tbl.device, tbl.data_ptr(),
                    tbl.shape[0], idx.data_ptr(), out.data_ptr(),
                    idx.shape[0])
    return out
