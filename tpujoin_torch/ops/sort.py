"""Key sort (the port of tpujoin/ops/sort.py).

The JAX package defers the single-device sort to ``jax.lax.sort``, an XLA
sort and not a Pallas kernel; its counterpart here is ``torch.sort``.
Stability is the public contract: equal keys keep their input order.
"""
from __future__ import annotations

import torch

from tpujoin_torch.core.table import Table


def sort_with_ids(keys: torch.Tensor):
    """Stable-sort keys ascending; returns (sorted_keys, permutation
    int32)."""
    sk, perm = torch.sort(keys, stable=True)
    return sk, perm.to(torch.int32)


def sort_by_key(table: Table, key_column: str = "key") -> Table:
    """Sort all columns of a table by one key column (stable); the key
    column comes first."""
    sk, perm = torch.sort(table[key_column], stable=True)
    out = {key_column: sk}
    out.update({n: c.index_select(0, perm)
                for n, c in table.columns.items() if n != key_column})
    return Table(out)
