"""(key, id) sort: K1, an LSD radix sort on two kernels (csrc/radix_sort.cu).

The counterpart of tpujoin/kernels/merge_sort.py, which sorts by a bitonic
tile sort and merge passes because a TPU has no vector scatter or gather.
On the H100 a merge tree costs more than the sort is worth: at 100M pairs
it is one tile sort and ceil(log2(1e8 / 2048)) = 16 merge passes, each
moving 16 B a pair (0.478 ms at 3.35 TB/s), so >= 8.1 ms even with every
pass at its byte bound, slower than PyTorch's own stable sort of the
keys. A radix sort of the 32-bit key in 8-bit digits reads the keys once
for the digit histograms (4 B a pair) and then makes four passes of 16 B
a pair: a floor of ~2.03 ms at 100M.

:func:`sort_histogram` counts all four digits of the keys (sign bit
flipped, so unsigned digit order is i32 order); :func:`sort_pass` is one
stable counting-sort pass on one digit; :func:`sort_pairs` chains one
histogram and always four passes, ping-ponging between two buffer pairs.
Any n sorts, with every i32 key: no sentinel keys, no padding.

:func:`sort_rows` is :func:`sort_pairs` of the keys and their row numbers
0..n-1, the ids of a join's build and probe sides. Its first pass is
:func:`sort_pass_iota`, the shift-0 pass that makes each id from the
pair's index: no id array is written before the sort, and the first pass
reads the keys alone (12 B a pair, not 16). The passes at shifts 8, 16
and 24 are :func:`sort_pass` as in :func:`sort_pairs`.

Each pass is stable, so the sort is: ties keep their input order, and
kernels and plain versions agree bitwise on keys and ids.

A CUDA tensor goes through the kernels, a CPU tensor through the plain
versions; anything else raises.
"""
from __future__ import annotations

import torch

from tpujoin_torch.kernels import _build
from tpujoin_torch.utils.shapes import cdiv

TILE = 7680             # pairs a sort_pass block ranks (PASS_TILE in the .cu)
RADIX = 256             # bins of an 8-bit digit
SHIFTS = (0, 8, 16, 24)  # the digits of a 32-bit key, least significant first


def _digit(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """The 8-bit digit at ``shift`` of the keys with the sign bit flipped,
    whose unsigned order is the keys' signed order."""
    return ((keys ^ torch.iinfo(torch.int32).min) >> shift) & (RADIX - 1)


def _check_shift(shift: int) -> None:
    if shift not in SHIFTS:
        raise ValueError(f"sort_pass: shift {shift} is not one of {SHIFTS}")


def sort_histogram_plain(keys: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`sort_histogram`: one bincount a digit."""
    return torch.stack([
        torch.bincount(_digit(keys, s).long(), minlength=RADIX)
        for s in SHIFTS]).to(torch.int32)


def sort_histogram(keys: torch.Tensor) -> torch.Tensor:
    """The (4, 256) int32 histograms of the keys' 8-bit digits, least
    significant first, sign bit flipped."""
    if _build.on_cpu(keys):
        return sort_histogram_plain(keys)
    _build.check_cuda_i32(keys)
    hist = torch.zeros((len(SHIFTS), RADIX), dtype=torch.int32,
                       device=keys.device)
    n = keys.shape[0]
    if n:
        _build.call("tj_sort_histogram", keys.device, keys.data_ptr(), n,
                    hist.data_ptr())
    return hist


def sort_pass_plain(keys: torch.Tensor, ids: torch.Tensor, shift: int):
    """The plain version of :func:`sort_pass`: a stable torch.sort of the
    digit, and a gather of keys and ids."""
    _check_shift(shift)
    _, order = torch.sort(_digit(keys, shift), stable=True)
    return keys[order], ids[order]


def sort_pass(keys: torch.Tensor, ids: torch.Tensor, shift: int,
              hist: torch.Tensor,
              out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """One stable pass of (keys, ids) on the 8-bit digit at ``shift`` (0,
    8, 16 or 24). ``hist`` is :func:`sort_histogram` of the keys, in any
    order of them; the kernel takes the digit's output offsets from it."""
    _check_shift(shift)
    _build.check_shapes("sort_pass", (hist, (len(SHIFTS), RADIX)))
    if _build.on_cpu(keys, ids):
        return sort_pass_plain(keys, ids, shift)
    ko, io = out if out is not None else (torch.empty_like(keys),
                                          torch.empty_like(ids))
    _build.check_cuda_i32(keys, ids, ko, io, hist.view(-1))
    n = keys.shape[0]
    if ids.shape[0] != n or ko.shape[0] != n or io.shape[0] != n:
        raise ValueError("keys, ids and outputs differ in length")
    if n and ({ko.data_ptr(), io.data_ptr()}
              & {keys.data_ptr(), ids.data_ptr()}):
        raise ValueError("sort_pass: the outputs overwrite the inputs")
    if n:
        # the tiles' status words and the ticket, zeroed by the entry point
        words = cdiv(n, TILE) * RADIX + 1
        scratch = torch.empty(words, dtype=torch.int64, device=keys.device)
        _build.call("tj_sort_pass", keys.device, keys.data_ptr(),
                    ids.data_ptr(), ko.data_ptr(), io.data_ptr(), n, shift,
                    hist.data_ptr(), scratch.data_ptr(), words)
    return ko, io


def sort_pass_iota_plain(keys: torch.Tensor):
    """The plain version of :func:`sort_pass_iota`: :func:`sort_pass_plain`
    at shift 0 of the keys and their indices."""
    ids = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    return sort_pass_plain(keys, ids, 0)


def sort_pass_iota(keys: torch.Tensor, hist: torch.Tensor,
                   out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """:func:`sort_pass` at shift 0 of (keys, 0..n-1): the kernel makes
    each id from its pair's index and reads no ids."""
    _build.check_shapes("sort_pass_iota", (hist, (len(SHIFTS), RADIX)))
    if _build.on_cpu(keys):
        return sort_pass_iota_plain(keys)
    ko, io = out if out is not None else (torch.empty_like(keys),
                                          torch.empty_like(keys))
    _build.check_cuda_i32(keys, ko, io, hist.view(-1))
    n = keys.shape[0]
    if ko.shape[0] != n or io.shape[0] != n:
        raise ValueError("keys and outputs differ in length")
    if n and keys.data_ptr() in {ko.data_ptr(), io.data_ptr()}:
        raise ValueError("sort_pass_iota: the outputs overwrite the keys")
    if n:
        words = cdiv(n, TILE) * RADIX + 1
        scratch = torch.empty(words, dtype=torch.int64, device=keys.device)
        _build.call("tj_sort_pass_iota", keys.device, keys.data_ptr(),
                    ko.data_ptr(), io.data_ptr(), n, hist.data_ptr(),
                    scratch.data_ptr(), words)
    return ko, io


def _sort(keys: torch.Tensor, ids: torch.Tensor | None):
    """One histogram, then four digit passes between two buffer pairs;
    with no ids the first is the iota pass."""
    hist = sort_histogram(keys)
    bufs = [(torch.empty_like(keys), torch.empty_like(keys))
            for _ in range(2)]
    k, i = keys, ids
    for p, shift in enumerate(SHIFTS):
        if i is None:
            k, i = sort_pass_iota(k, hist, out=bufs[p % 2])
        else:
            k, i = sort_pass(k, i, shift, hist, out=bufs[p % 2])
    return k, i


def sort_pairs(keys: torch.Tensor, ids: torch.Tensor):
    """Stable ascending sort of (key i32, id i32) pairs of any length: one
    histogram, then always four digit passes between two buffer pairs,
    with no read back to the host. The inputs are left as they are and the
    result is always new tensors. On CPU tensors it is
    :func:`sort_pairs_plain`, which gives the same answer."""
    if _build.on_cpu(keys, ids):
        return sort_pairs_plain(keys, ids)
    return _sort(keys, ids)


def sort_rows(keys: torch.Tensor):
    """(sorted keys, row ids): bitwise ``sort_pairs(keys, arange(n))``,
    with no arange. On a CPU tensor it is :func:`sort_rows_plain`."""
    if _build.on_cpu(keys):
        return sort_rows_plain(keys)
    return _sort(keys, None)


def sort_pairs_plain(keys: torch.Tensor, ids: torch.Tensor):
    """The plain version of :func:`sort_pairs`: torch.sort + gather."""
    sk, order = torch.sort(keys, stable=True)
    return sk, ids[order]


def sort_rows_plain(keys: torch.Tensor):
    """The plain version of :func:`sort_rows`: a stable torch.sort, whose
    order is the row ids."""
    sk, order = torch.sort(keys, stable=True)
    return sk, order.to(torch.int32)
