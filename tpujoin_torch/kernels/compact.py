"""Stream compaction: K3 and K6 (csrc/compact.cu).

The port of tpujoin/kernels/compact.py's three kernels, each a stable
compaction of the rows whose mask is set, at width ``k_cap``:

  compact_ids   (K6a)  the row ids themselves, -1 from ``nonzero`` on;
  compact_cols  (K6b)  1 to 8 i32 columns under one mask, zero tail;
  compact3      (K3)   (lo, cnt, sid) under cnt > 0, zero tail: the
                       NCOLS = 3 case of K6b's kernel.

A mask is bool (set when True) or int32 (set when > 0). On the card K6a
is one scan with a decoupled look-back that reads the mask once (a memset
of its status words, the scan, and a launch for the -1 tail); K3 and K6b
are a count pass, ``torch.cumsum`` of the block counts and a scatter pass.
The result always fits, so there is no ``fits`` flag, and ``nonzero``
stays a 0-d int64 tensor on the device. A CUDA tensor goes through the
kernels, a CPU tensor through the ``*_plain`` version; anything else
raises.
"""
from __future__ import annotations

import ctypes

import torch

from tpujoin_torch.kernels import _build
from tpujoin_torch.utils.shapes import cdiv

BLOCK_ROWS = 1024   # rows per block of K3's and K6b's two passes
MAX_COLS = 8        # the most columns one compact_cols launch takes


def _keep(mask: torch.Tensor) -> torch.Tensor:
    """The rows ``mask`` keeps, as a bool tensor."""
    if mask.dtype == torch.bool:
        return mask
    if mask.dtype == torch.int32:
        return mask > 0
    raise ValueError(f"mask must be bool or int32, got {mask.dtype}")


def compact_ids_plain(mask: torch.Tensor, k_cap: int):
    """``torch.nonzero`` of the mask, cut or padded with -1 to k_cap."""
    keep = _keep(mask)
    ids = torch.nonzero(keep).squeeze(1)[:k_cap]
    out = torch.full((k_cap,), -1, dtype=torch.int32, device=mask.device)
    out[:ids.shape[0]] = ids
    return out, keep.sum(dtype=torch.int64)


def compact_cols_plain(mask: torch.Tensor, cols, k_cap: int):
    """Boolean-mask compaction of each column, cut or zero-padded to
    k_cap."""
    keep = _keep(mask)
    outs = []
    for col in cols:
        kept = col[keep][:k_cap]
        out = torch.zeros(k_cap, dtype=col.dtype, device=col.device)
        out[:kept.shape[0]] = kept
        outs.append(out)
    return tuple(outs), keep.sum(dtype=torch.int64)


def compact3_plain(lo: torch.Tensor, cnt: torch.Tensor, sid: torch.Tensor,
                   k_cap: int):
    """compact_cols_plain of (lo, cnt, sid) under cnt > 0."""
    return compact_cols_plain(cnt, (lo, cnt, sid), k_cap)[0]


def _mask_i32(mask: torch.Tensor, device: torch.device) -> int:
    """1 for an int32 mask, 0 for a bool one; raises unless it is a
    contiguous 1-D CUDA tensor on ``device`` with fewer than 2^31 rows."""
    if mask.device != device or mask.device.type != "cuda":
        raise ValueError(f"mask on {mask.device}, expected {device}")
    if mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError(f"expected a contiguous 1-D mask, got "
                         f"{tuple(mask.shape)}")
    if mask.shape[0] >= 1 << 31:
        raise ValueError("row ids are int32: the mask has >= 2^31 rows")
    if mask.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"mask must be bool or int32, got {mask.dtype}")
    return int(mask.dtype == torch.int32)


def _offsets(mask: torch.Tensor, mask_i32: int):
    """Count pass and glue: each block's first output slot (int64) and a
    1-element view of the total."""
    n = mask.shape[0]
    counts = torch.empty(cdiv(n, BLOCK_ROWS), dtype=torch.int32,
                         device=mask.device)
    _build.call("tj_compact_count", mask.device, mask.data_ptr(), mask_i32,
                n, counts.data_ptr())
    incl = torch.cumsum(counts, 0, dtype=torch.int64)
    return incl - counts, incl[-1:]


def compact_ids(mask: torch.Tensor, k_cap: int):
    """(ids, nonzero): the ascending row ids of the set mask rows, the
    first k_cap of them, -1 from slot nonzero on; ``nonzero`` is the
    number of set rows (0-d int64). The mask may be a view starting at
    any row."""
    if _build.on_cpu(mask):
        return compact_ids_plain(mask, k_cap)
    mask_i32 = _mask_i32(mask, mask.device)
    out = torch.empty(k_cap, dtype=torch.int32, device=mask.device)
    n = mask.shape[0]
    if n == 0:
        return out.fill_(-1), out.new_zeros((), dtype=torch.int64)
    words = _build.size("tj_compact_ids_scratch_words", mask.data_ptr(),
                        mask_i32, n)
    scratch = torch.empty(words, dtype=torch.int64, device=mask.device)
    nonzero = torch.empty((), dtype=torch.int64, device=mask.device)
    _build.call("tj_compact_ids", mask.device, mask.data_ptr(), mask_i32, n,
                scratch.data_ptr(), words, out.data_ptr(), k_cap,
                nonzero.data_ptr())
    return out, nonzero


def _launch_cols(mask: torch.Tensor, cols, k_cap: int):
    """The kernel path of compact_cols and compact3 (the caller counts the
    launch): (outs, nonzero)."""
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"1 to {MAX_COLS} columns, got {len(cols)}")
    dev = cols[0].device
    mask_i32 = _mask_i32(mask, dev)
    n = mask.shape[0]
    if any(c.shape[0] != n for c in cols):
        raise ValueError("compact_cols: columns and mask differ in length")
    outs = [torch.empty(k_cap, dtype=torch.int32, device=dev) for _ in cols]
    _build.check_cuda_i32(*cols, *outs)
    if n == 0:
        return tuple(o.zero_() for o in outs), outs[0].new_zeros(
            (), dtype=torch.int64)
    offsets, total = _offsets(mask, mask_i32)
    ins = (ctypes.c_void_p * len(cols))(*(c.data_ptr() for c in cols))
    outp = (ctypes.c_void_p * len(cols))(*(o.data_ptr() for o in outs))
    _build.call("tj_compact_cols", dev, mask.data_ptr(), mask_i32, n,
                offsets.data_ptr(), total.data_ptr(), len(cols),
                ctypes.addressof(ins), ctypes.addressof(outp), k_cap)
    return tuple(outs), total[0]


def compact_cols(mask: torch.Tensor, cols, k_cap: int):
    """(outs, nonzero): every column of ``cols`` (1 to 8 int32 tensors)
    compacted to the set mask rows, in order, the first k_cap of them,
    zero-padded; ``nonzero`` as in :func:`compact_ids`."""
    if _build.on_cpu(mask, *cols):
        return compact_cols_plain(mask, cols, k_cap)
    outs, nonzero = _launch_cols(mask, tuple(cols), k_cap)
    return outs, nonzero


def compact3(lo: torch.Tensor, cnt: torch.Tensor, sid: torch.Tensor,
             k_cap: int):
    """(lo_c, cnt_c, sid_c): the rows with cnt > 0 in input order, the
    first k_cap of them, zero-padded to k_cap."""
    if _build.on_cpu(lo, cnt, sid):
        return compact3_plain(lo, cnt, sid, k_cap)
    outs, _ = _launch_cols(cnt, (lo, cnt, sid), k_cap)
    return outs
