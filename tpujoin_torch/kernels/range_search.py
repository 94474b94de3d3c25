"""Equal-range search through a key-range directory (csrc/range_search.cu):
v1's count on the card.

For unsorted probe keys and sorted build keys, each probe key's lower
bound ``lo`` in the build keys and its number of equal build keys ``cnt``,
both int32 in probe order: what ``torch.searchsorted``, left and right,
gives. No TPU kernel is ported here (the JAX package's v1 count is XLA's
searchsorted); the kernel replaces that library call on the card.

Two launches a count:

- :func:`directory` cuts the build keys' range into 2^p buckets of width
  2^shift from the smallest key: ``dir[b]`` is the lower bound of
  ``kmin + (b << shift)``, for b in [0, 2^p]. p comes from the number of
  build keys (:func:`bucket_bits`, 32-64 keys a bucket at uniform keys);
  ``kmin`` and ``shift`` come from the keys on the device. ``params``
  holds (kmin, shift, the largest bucket's rows), int64; the last is a
  counter of how well the directory spreads the keys, and nothing on the
  join path reads it.
- :func:`search_count` finds each probe key's bucket and its two bounds
  inside it (the kernel starts at the sector of the key's place
  interpolated in the bucket; at shift 0 the bucket is the key's run).

A CUDA tensor goes through the kernels, a CPU tensor through
:func:`directory_plain` and :func:`search_count_plain`; anything else
raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build

PARAMS = 3              # kmin, shift, largest bucket


def bucket_bits(n: int) -> int:
    """p for ``n`` build keys: the largest p with 32 * 2^p <= n (0 below
    64 keys), so a bucket holds 32 to 64 keys at uniform keys and the
    directory, n / 8 to n / 16 bytes, stays in L2 up to ~4e8 keys."""
    return max(0, (n // 32).bit_length() - 1)


def directory_plain(keys: torch.Tensor):
    """(dir, params) in torch ops: the lower bound of every bucket start,
    [2^p + 1] int32, and (kmin, shift, largest bucket) as int64."""
    n, p, dev = keys.shape[0], bucket_bits(keys.shape[0]), keys.device
    kmin, kmax = (int(keys[0]), int(keys[-1])) if n else (0, 0)
    shift = max(0, (kmax - kmin).bit_length() - p)
    starts = kmin + (torch.arange((1 << p) + 1, dtype=torch.int64,
                                  device=dev) << shift)
    dir_ = torch.searchsorted(keys.long(), starts).int()
    largest = int((dir_[1:] - dir_[:-1]).max())
    return dir_, torch.tensor([kmin, shift, largest], dtype=torch.int64,
                              device=dev)


def _bounded(keys, x, start, end, upper: bool):
    """The lower (or upper) bound of each x in keys[start, end), by a
    binary search of all of them a level a step."""
    at, left = start, end - start
    while bool((left > 0).any()):
        live = left > 0
        half = left >> 1
        v = keys[(at + half).clamp(max=keys.shape[0] - 1)]
        step = live & ((v <= x) if upper else (v < x))
        at = torch.where(step, at + half + 1, at)
        left = torch.where(step, left - half - 1,
                           torch.where(live, half, left))
    return at


def search_count_plain(keys: torch.Tensor, probe: torch.Tensor,
                       dir_: torch.Tensor, params: torch.Tensor):
    """(lo, cnt) in torch ops: each probe key's bucket, then its lower and
    upper bound inside it; a key below kmin gets (0, 0), one past the last
    bucket (n, 0)."""
    n, buckets = keys.shape[0], dir_.shape[0] - 1
    x = probe.long()
    d = x - params[0]
    b = d >> params[1]
    inside = (d >= 0) & (b < buckets)
    bc = b.clamp(0, buckets - 1)
    outside = torch.where(d < 0, 0, n)
    start = torch.where(inside, dir_[bc].long(), outside)
    end = torch.where(inside, dir_[bc + 1].long(), outside)
    lo = _bounded(keys, x, start, end, upper=False)
    hi = _bounded(keys, x, start, end, upper=True)
    return lo.int(), (hi - lo).int()


def _check_params(params: torch.Tensor, keys: torch.Tensor) -> None:
    if (params.dtype != torch.int64 or tuple(params.shape) != (PARAMS,)
            or not params.is_contiguous() or params.device != keys.device):
        raise ValueError(f"range_search: expected contiguous int64 "
                         f"({PARAMS},) params on {keys.device}, got "
                         f"{params.dtype} {tuple(params.shape)} on "
                         f"{params.device}")


def _check_keys(keys: torch.Tensor) -> int:
    n = keys.shape[0]
    if n >= 2**31:
        raise ValueError("range_search: more than 2^31 - 1 build keys")
    return n


def directory(keys: torch.Tensor):
    """(dir, params) of the ascending build keys: one launch on the card,
    no host read."""
    if _build.on_cpu(keys):
        return directory_plain(keys)
    n, p = _check_keys(keys), bucket_bits(keys.shape[0])
    dir_ = torch.empty((1 << p) + 1, dtype=torch.int32, device=keys.device)
    params = torch.empty(PARAMS, dtype=torch.int64, device=keys.device)
    _build.check_cuda_i32(keys, dir_)
    _build.call("tj_search_dir", keys.device, keys.data_ptr(), n, p,
                dir_.data_ptr(), params.data_ptr())
    return dir_, params


def search_count(keys: torch.Tensor, probe: torch.Tensor,
                 dir_: torch.Tensor, params: torch.Tensor):
    """(lo, cnt) of the probe keys, through :func:`directory`'s (dir,
    params) of the same build keys: one launch on the card."""
    if _build.on_cpu(keys, probe, dir_, params):
        return search_count_plain(keys, probe, dir_, params)
    n, p = _check_keys(keys), bucket_bits(keys.shape[0])
    lo, cnt = torch.empty_like(probe), torch.empty_like(probe)
    _build.check_cuda_i32(keys, probe, dir_, lo, cnt)
    _build.check_shapes("range_search", (dir_, ((1 << p) + 1,)))
    _check_params(params, keys)
    _build.call("tj_search_count", probe.device, keys.data_ptr(), n,
                probe.data_ptr(), probe.shape[0], dir_.data_ptr(), p,
                params.data_ptr(), lo.data_ptr(), cnt.data_ptr())
    return lo, cnt


def equal_range(keys: torch.Tensor, probe: torch.Tensor):
    """(lo, cnt) of the probe keys in the ascending build keys: the
    directory, then the search."""
    return search_count(keys, probe, *directory(keys))
