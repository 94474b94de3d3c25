"""Nested-loop join with full row materialization (the port of
tpujoin/ops/nested_loop_join.py).

Capability parity with reference nested-loop.mlir:1-292: the quadratic
join that works for any predicate shape, materializes full result rows and
doubles as an on-device oracle for the hash join. The [n, m] equality
matrix is compared densely and compacted with the filter's compaction (K6a
on the card). O(n * m) by design, for small and medium relations; the mask
has at most 2^31 - 1 cells, since a cell's id is an i32.
"""
from __future__ import annotations

import numpy as np
import torch

from tpujoin_torch.core.table import Table
from tpujoin_torch.ops.filter import filter_materialize
from tpujoin_torch.utils.device import i32_columns
from tpujoin_torch.utils.shapes import round_up


def nested_loop_count(r_keys: torch.Tensor,
                      s_keys: torch.Tensor) -> torch.Tensor:
    """Count pass (reference nested-loop.mlir:78-88): |{(i, j): R[i] ==
    S[j]}| as a 0-d int64 tensor."""
    return (r_keys[:, None] == s_keys[None, :]).sum(dtype=torch.int64)


def nested_loop_materialize(r_keys: torch.Tensor, s_keys: torch.Tensor,
                            capacity: int):
    """Write pass (reference nested-loop.mlir:160-188): all matching
    (rowID_R, rowID_S) pairs in row-major order, padded to capacity with
    -1; plus the total (0-d int64)."""
    m = max(s_keys.shape[0], 1)   # with no S row, every slot is -1
    eq = (r_keys[:, None] == s_keys[None, :]).reshape(-1)
    flat, total = filter_materialize(eq, capacity)
    valid = flat >= 0
    neg = torch.tensor(-1, dtype=torch.int32, device=flat.device)
    r_ids = torch.where(valid, flat // m, neg).to(torch.int32)
    s_ids = torch.where(valid, flat % m, neg).to(torch.int32)
    return r_ids, s_ids, total


def nested_loop_join(r_keys, s_keys, *,
                     device: torch.device | str | None = None,
                     pad_multiple: int = 1 << 16):
    """Driver (replaces @main, reference nested-loop.mlir:195-289):
    exact-size (rowID_R, rowID_S) pairs as numpy int32 arrays. Keys are
    numpy arrays or tensors; ``device`` defaults to the tensors' device,
    else CUDA."""
    rk, sk = i32_columns(r_keys, s_keys, device=device)
    total = int(nested_loop_count(rk, sk))
    if total == 0:
        return np.empty((0,), np.int32), np.empty((0,), np.int32)
    r_ids, s_ids, _ = nested_loop_materialize(rk, sk,
                                              round_up(total, pad_multiple))
    return r_ids[:total].cpu().numpy(), s_ids[:total].cpu().numpy()


def materialize_join_rows(r: Table, s: Table, r_ids, s_ids,
                          key_column: str = "key") -> Table:
    """Full-row result materialization (reference nested-loop.mlir:170-183):
    every column of R plus every column of S except S's copy of the join
    key, gathered at the matching row ids. Columns are prefixed r_/s_."""
    r_idx = torch.as_tensor(r_ids, device=r.device).long()
    s_idx = torch.as_tensor(s_ids, device=s.device).long()
    out = {f"r_{name}": col.index_select(0, r_idx)
           for name, col in r.columns.items()}
    out.update({f"s_{name}": col.index_select(0, s_idx)
                for name, col in s.columns.items() if name != key_column})
    return Table(out)
