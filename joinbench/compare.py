"""The comparisons that decide ``correct``: a program's join outputs held
against the reference's factorized join (:mod:`joinbench.reference`).

Every number here counts a departure from the exact result, so each
limit is 0. The pairs are compared as a multiset without a sort: a pair
(r, s) is a true match when r's sorted position lies in s's range, and
then it names one slot of the reference's result; the columns are right
when every pair is a true match and every slot is named exactly once.
"""
from __future__ import annotations

import torch

from joinbench.reference import Factorized

BLOCK_PAIRS = 1 << 26   # pairs checked at once


def count_checks(probe_ids: torch.Tensor, counts: torch.Tensor, total: int,
                 nonzero: int, f: Factorized) -> dict:
    """The count layer's outputs: its total, its matched-row count, and
    each probe row's matches, given as (probe id, count) rows in any
    order. A row whose id is missing, repeated or out of range is off."""
    m = f.cnt.numel()
    ids = probe_ids.long()
    valid = (ids >= 0) & (ids < m)
    ids, cnt = ids[valid], counts.long()[valid]
    seen = torch.bincount(ids, minlength=m)
    got = torch.zeros(m, dtype=torch.int64, device=ids.device)
    got.index_add_(0, ids, cnt)
    off = int(((seen != 1) | (got != f.cnt)).sum()) + int((~valid).sum())
    return {"count_total_gap": abs(total - f.total),
            "count_nonzero_gap": abs(nonzero - f.nonzero),
            "count_rows_off": off}


def pair_checks(build_ids: torch.Tensor, probe_ids: torch.Tensor,
                total: int, f: Factorized,
                block_pairs: int = BLOCK_PAIRS) -> dict:
    """The pair columns' first ``total`` slots against the reference's
    result: ``pairs_off`` counts the pairs that are no match, the slots
    named twice or more, and the slots not named, so it is 0 exactly when
    the two multisets are equal."""
    n, m = f.where.numel(), f.cnt.numel()
    dev = f.cnt.device
    given = min(total, build_ids.numel(), probe_ids.numel())
    seen = torch.zeros(f.total, dtype=torch.bool, device=dev)
    bad = good = 0
    for a in range(0, given, block_pairs):
        b = min(a + block_pairs, given)
        r = build_ids[a:b].to(dev, torch.int64)
        s = probe_ids[a:b].to(dev, torch.int64)
        ok = (r >= 0) & (r < n) & (s >= 0) & (s < m)
        r, s = r.where(ok, 0), s.where(ok, 0)
        pos = f.where[r] - f.lo[s]
        ok &= (pos >= 0) & (pos < f.cnt[s])
        seen[(f.offs[s] + pos)[ok]] = True
        kept = int(ok.sum())
        good += kept
        bad += (b - a) - kept
    distinct = int(seen.sum())
    return {"pairs_off": bad + (total - given) + (good - distinct)
            + (f.total - distinct)}
