"""Columnar Table: the engine's relation representation (the port of
tpujoin/core/table.py).

A relation is a named dict of equal-length 1-D tensors on one device. The
JAX package's pytree protocol and ``device_put`` are JAX plumbing and have
no counterpart: a table moves with :meth:`Table.to`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from tpujoin_torch.utils.device import resolve_device


@dataclasses.dataclass
class Table:
    """A columnar relation: equal-length 1-D columns keyed by name."""

    columns: dict

    def __post_init__(self):
        lengths = {name: int(col.shape[0])
                   for name, col in self.columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        devices = {str(col.device) for col in self.columns.values()}
        if len(devices) > 1:
            raise ValueError(f"columns on several devices: {devices}")

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return int(next(iter(self.columns.values())).shape[0])

    @property
    def column_names(self) -> tuple:
        return tuple(self.columns)

    @property
    def device(self) -> torch.device | None:
        """The columns' device (None for a table without columns)."""
        return next((c.device for c in self.columns.values()), None)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def select(self, *names: str) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def with_column(self, name: str, col: torch.Tensor) -> "Table":
        new = dict(self.columns)
        new[name] = col
        return Table(new)

    def gather(self, row_ids: torch.Tensor) -> "Table":
        """The given rows of every column, in the order of ``row_ids``."""
        idx = row_ids.long()
        return Table({n: c.index_select(0, idx)
                      for n, c in self.columns.items()})

    def to(self, device: torch.device | str) -> "Table":
        return Table({n: c.to(device) for n, c in self.columns.items()})

    def to_numpy(self) -> Mapping[str, np.ndarray]:
        return {n: c.cpu().numpy() for n, c in self.columns.items()}

    @classmethod
    def from_numpy(cls, cols: Mapping[str, np.ndarray],
                   device: torch.device | str) -> "Table":
        return cls({n: torch.as_tensor(np.asarray(c), device=device)
                    for n, c in cols.items()})

    @classmethod
    def arange_index(cls, n: int, name: str = "rowid",
                     device: torch.device | str = "cuda") -> "Table":
        """0..n-1 index column (reference shared.cpp:35-41
        initRelationIndex)."""
        return cls({name: torch.arange(n, dtype=torch.int32, device=device)})


def as_table(table, device: torch.device | str | None = None) -> Table:
    """``table`` as a Table: a Table stays where it is unless ``device``
    is given; a mapping of numpy arrays goes to ``device``, by default
    CUDA (which must then be present)."""
    if not isinstance(table, Table):
        return Table.from_numpy(table, resolve_device(device=device))
    if device is not None:
        return table.to(resolve_device(device=device))
    return table
