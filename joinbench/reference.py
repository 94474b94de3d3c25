"""The plain reference of an exact equi-join, in PyTorch.

The join of build keys R and probe keys S is every (build row r, probe row
s) with R[r] == S[s], each exactly once. The reference states it in
factorized form: the build rows sorted by (key, row id), and for each
probe row the range of sorted positions that holds its key. Probe row s
then owns the slots ``offs[s] .. offs[s] + cnt[s]`` of the result in
probe-row order, and slot ``offs[s] + j`` is the pair
(``order[lo[s] + j]``, s).

It imports nothing of the program under test, takes only the keys, and
runs on the keys' device in blocks of probe rows, so that a result of
about 1e9 pairs can be checked beside the program's own columns. A
configuration names it as its ``reference``; the harness calls
:func:`judge_ref` on an op's named inputs.
"""
from __future__ import annotations

import dataclasses

import torch

BLOCK_ROWS = 1 << 24   # probe rows searched at once


@dataclasses.dataclass
class Factorized:
    """The join in factorized form, every column int64 on the keys'
    device."""

    order: torch.Tensor   # [n] build row at each sorted position
    where: torch.Tensor   # [n] sorted position of each build row
    lo: torch.Tensor      # [m] first sorted position of each probe key
    cnt: torch.Tensor     # [m] matches of each probe row
    offs: torch.Tensor    # [m] first result slot of each probe row
    total: int            # pairs in the result
    nonzero: int          # probe rows with at least one match


def factorize(build_keys: torch.Tensor, probe_keys: torch.Tensor,
              block_rows: int = BLOCK_ROWS) -> Factorized:
    """The join of ``build_keys`` and ``probe_keys`` (1-D integer tensors
    on one device) in factorized form."""
    n, m = build_keys.numel(), probe_keys.numel()
    dev = build_keys.device
    sorted_keys, order = torch.sort(build_keys, stable=True)
    where = torch.empty_like(order)
    where[order] = torch.arange(n, device=dev)
    lo = torch.empty(m, dtype=torch.int64, device=dev)
    cnt = torch.empty_like(lo)
    for a in range(0, m, block_rows):
        keys = probe_keys[a:a + block_rows]
        first = torch.searchsorted(sorted_keys, keys)
        lo[a:a + block_rows] = first
        cnt[a:a + block_rows] = torch.searchsorted(sorted_keys, keys,
                                                   right=True) - first
    del sorted_keys
    offs = torch.cumsum(cnt, 0) - cnt
    return Factorized(order, where, lo, cnt, offs,
                      int(cnt.sum()), int((cnt > 0).sum()))


def judge_ref(inputs: dict) -> Factorized:
    """The join of an op's inputs ``build_keys`` and ``probe_keys``."""
    return factorize(inputs["build_keys"], inputs["probe_keys"])
