"""Selection with stream compaction (the port of tpujoin/ops/filter.py).

Capability parity with the reference's selection kernel
(reference Experiments/selection.mlir:32-157): evaluate a predicate over a
column and densely compact the passing rows. On the card the compaction is
K6a ``compact_ids`` (kernels/compact.py): a count pass, a cumsum of the
block counts and an in-order scatter, the reference's own three steps. The
JAX package's packed-sort compaction and its kernel envelope fallback are
TPU workarounds and have no counterpart.
"""
from __future__ import annotations

import torch

from tpujoin_torch.core.table import as_table
from tpujoin_torch.kernels.compact import compact_ids
from tpujoin_torch.utils.device import resolve_device
from tpujoin_torch.utils.shapes import round_up


def filter_count(mask: torch.Tensor) -> torch.Tensor:
    """Count phase: the exact number of passing rows (0-d int64)."""
    return mask.sum(dtype=torch.int64)


def filter_materialize(mask: torch.Tensor, capacity: int):
    """(ids, total): the ascending row ids of the passing rows in
    [capacity] int32, -1 from slot ``total`` on, cut to capacity (the
    drivers size capacity from the count, so nothing is lost); ``total`` is
    the exact count (0-d int64)."""
    return compact_ids(mask, capacity)


def filter_table(table, predicate, column: str, *,
                 device: torch.device | str | None = None,
                 pad_multiple: int = 1 << 16, return_numpy: bool = False):
    """Filter driver (replaces @main of selection.mlir:159-195): the rows
    of ``table`` whose ``column`` passes ``predicate`` (an elementwise
    torch function, e.g. ``lambda v: v < 80.0``, the reference's predicate
    at selection.mlir:61), as a new exact-size Table, or a dict of numpy
    arrays with ``return_numpy``. ``table`` is a Table, or a mapping of
    numpy arrays that goes to ``device`` (default: the Table's device, else
    CUDA)."""
    table = as_table(table, device)
    mask = predicate(table[column])
    total = int(filter_count(mask))
    ids, _ = filter_materialize(mask, round_up(total, pad_multiple))
    out = table.gather(ids[:total])
    return out.to_numpy() if return_numpy else out


def filter_device(values, threshold, capacity: int, *,
                  device: torch.device | str | None = None):
    """Fixed-capacity filter: (ids, total) of the rows with value <
    threshold (the reference's exact workload, selection.mlir:61).
    ``values`` is a tensor or a numpy array (then on ``device``, default
    CUDA)."""
    values = torch.as_tensor(values,
                             device=resolve_device(values, device=device))
    return filter_materialize(values < threshold, capacity)
