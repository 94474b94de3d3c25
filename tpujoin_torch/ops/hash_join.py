"""Build phase of the equi-join (the port of tpujoin/ops/hash_join.py's
``HashJoinTable`` and ``build``).

The build side sorted by key plays the hash table: every key's matches are
one contiguous [lo, lo + cnt) range of ``sorted_ids``. The sort is K1
(kernels/merge_sort.py) for a CUDA tensor at every size.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpujoin_torch.kernels.merge_sort import sort_pairs


@dataclasses.dataclass
class HashJoinTable:
    """The built side: keys sorted ascending and the row ids under the sort."""

    sorted_keys: torch.Tensor   # [n] i32, ascending
    sorted_ids: torch.Tensor    # [n] i32

    @property
    def num_rows(self) -> int:
        return int(self.sorted_keys.shape[0])

    @classmethod
    def from_numpy(cls, sorted_keys: np.ndarray, sorted_ids: np.ndarray,
                   device: torch.device | str = "cpu") -> "HashJoinTable":
        """A table from another implementation's state (e.g. the JAX
        package's, through ``np.asarray`` of its fields)."""
        return cls(_i32_tensor(sorted_keys, device),
                   _i32_tensor(sorted_ids, device))


def _i32_tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)


def build(build_keys: torch.Tensor) -> HashJoinTable:
    """Build phase: one (key, row id) sort."""
    n = build_keys.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=build_keys.device)
    sk, sid = sort_pairs(build_keys, ids)
    return HashJoinTable(sk, sid)
