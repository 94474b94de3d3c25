"""Radix partitioning: hash, histogram and stable reorder by key digits (the
port of tpujoin/ops/radix.py).

The partitioning primitive behind the distributed shuffle join. torch has
few uint32 operations, so the 32-bit hash runs in int64 masked to 32 bits
and comes back as int64 in [0, 2^32), bit-identical to the JAX package's
uint32. The stable reorders are ``torch.sort(stable=True)``, where the JAX
package uses ``jax.lax.sort``; neither is a Pallas kernel.
"""
from __future__ import annotations

import torch

_MASK32 = (1 << 32) - 1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for x in [0, 2^32), in int64 without overflow: the
    16-bit halves of c, the high product cut to 16 bits before its
    shift."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + hi * (1 << 16)) & _MASK32


def hash32(keys: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer (public-domain integer mix) of i32 keys as uint32
    values in int64: decorrelates key bits before partition assignment, so
    ``key % P`` patterns in the data cannot skew partitions."""
    x = keys.long() & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def partition_ids(keys: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Partition of each key, uniform over [0, num_partitions) for any key
    distribution (int32)."""
    return (hash32(keys) % num_partitions).to(torch.int32)


def radix_partition(keys: torch.Tensor, row_ids: torch.Tensor,
                    num_partitions: int):
    """Reorder (keys, row_ids) so partition p's rows are contiguous, in
    input order within a partition. Returns (pkeys, pids, offsets,
    counts): offsets[p] is partition p's start in the reordered arrays and
    counts[p] its size (CSR layout), both int32."""
    pid = partition_ids(keys, num_partitions)
    _, perm = torch.sort(pid, stable=True)
    counts = torch.bincount(pid, minlength=num_partitions).to(torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return keys[perm], row_ids[perm], offsets, counts


def radix_sort(keys: torch.Tensor, bits_per_pass: int = 8):
    """LSD radix sort over i32 keys; returns (sorted_keys, permutation
    int32). Each digit pass is a stable reorder keyed on the digit of the
    keys biased to unsigned order, so negative keys sort correctly."""
    cur = (keys.long() & _MASK32) ^ (1 << 31)
    perm = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    for shift in range(0, 32, bits_per_pass):
        digit = (cur >> shift) & ((1 << bits_per_pass) - 1)
        _, order = torch.sort(digit, stable=True)
        cur, perm = cur[order], perm[order]
    return (cur - (1 << 31)).to(torch.int32), perm   # biased = key + 2^31
