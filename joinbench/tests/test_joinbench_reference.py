"""The reference and the comparisons, held against a brute-force nested
loop on small keys."""
from collections import Counter

import numpy as np
import pytest
import torch

from joinbench import compare, reference

IMIN, IMAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def nested_loop(bk, pk):
    """Every (build row, probe row) pair with equal keys."""
    return Counter((r, s) for s in range(len(pk)) for r in range(len(bk))
                   if bk[r] == pk[s])


def keys(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "duplicates":
        return rng.integers(1, 9, 60), rng.integers(1, 12, 50)
    if kind == "extremes":
        pool = np.array([IMIN, IMIN + 1, -1, 0, 1, IMAX - 1, IMAX])
        return rng.choice(pool, 40), rng.choice(pool, 45)
    if kind == "empty_build":
        return np.array([], np.int64), rng.integers(0, 5, 20)
    if kind == "empty_probe":
        return rng.integers(0, 5, 20), np.array([], np.int64)
    if kind == "no_match":
        return np.arange(0, 40, 2), np.arange(1, 41, 2)
    return np.array([7] * 30), np.array([7] * 20)   # one key everywhere


KINDS = ["duplicates", "extremes", "empty_build", "empty_probe",
         "no_match", "all_equal"]


def tensors(kind):
    bk, pk = keys(kind)
    return (torch.tensor(bk, dtype=torch.int32),
            torch.tensor(pk, dtype=torch.int32), bk, pk)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block", [1, 7, 1 << 20])
def test_pairs_and_counts_match_the_nested_loop(kind, block):
    bkt, pkt, bk, pk = tensors(kind)
    f = reference.factorize(bkt, pkt, block_rows=block)
    want = nested_loop(bk, pk)
    assert f.total == sum(want.values())
    assert f.nonzero == len({s for _, s in want})
    assert f.cnt.tolist() == [sum(1 for r in range(len(bk)) if bk[r] == k)
                              for k in pk]
    cnt = f.cnt.tolist()
    assert f.offs.tolist() == [sum(cnt[:s]) for s in range(len(pk))]
    assert (f.where[f.order] == torch.arange(len(bk))).all()
    # slot offs[s] + j holds the pair (order[lo[s] + j], s)
    got = Counter((int(f.order[f.lo[s] + j]), s) for s in range(len(pk))
                  for j in range(int(f.cnt[s])))
    assert got == want


def exact_columns(kind):
    bkt, pkt, bk, pk = tensors(kind)
    pairs = sorted(nested_loop(bk, pk))
    rng = np.random.default_rng(3)
    rng.shuffle(pairs)
    r = torch.tensor([p[0] for p in pairs], dtype=torch.int32)
    s = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    return reference.factorize(bkt, pkt), r, s


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block", [1, 3, 1 << 20])
def test_pair_checks_pass_the_exact_multiset_in_any_order(kind, block):
    f, r, s = exact_columns(kind)
    pad = torch.full((5,), -1, dtype=torch.int32)
    assert compare.pair_checks(torch.cat([r, pad]), torch.cat([s, pad]),
                               f.total, f, block_pairs=block) == \
        {"pairs_off": 0}


FAULTS = {
    "wrong_build_row": lambda r, s: (torch.cat([(r[:1] + 1) % 60, r[1:]]),
                                     s),
    "duplicate_for_missing": lambda r, s: (torch.cat([r[1:2], r[1:]]),
                                           torch.cat([s[1:2], s[1:]])),
    "one_pair_dropped": lambda r, s: (r[1:], s[1:]),
    "out_of_range": lambda r, s: (torch.cat([r[:-1], r.new_tensor([999])]),
                                  s),
    "probe_id_negative": lambda r, s: (r, torch.cat([s[:-1],
                                                     s.new_tensor([-1])])),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_pair_checks_count_each_fault(fault):
    f, r, s = exact_columns("duplicates")
    r, s = FAULTS[fault](r, s)
    total = f.total - (fault == "one_pair_dropped")
    assert compare.pair_checks(r, s, total, f)["pairs_off"] > 0


def count_state(kind):
    bkt, pkt, _, _ = tensors(kind)
    f = reference.factorize(bkt, pkt)
    perm = torch.randperm(pkt.numel(), generator=torch.Generator()
                          .manual_seed(5))
    return f, perm, f.cnt[perm].int()


@pytest.mark.parametrize("kind", KINDS)
def test_count_checks_pass_the_exact_counts_in_any_order(kind):
    f, ids, cnt = count_state(kind)
    assert compare.count_checks(ids, cnt, f.total, f.nonzero, f) == {
        "count_total_gap": 0, "count_nonzero_gap": 0, "count_rows_off": 0}


def test_count_checks_count_a_wrong_count_and_a_repeated_id():
    f, ids, cnt = count_state("duplicates")
    wrong = cnt.clone()
    wrong[3] += 1
    assert compare.count_checks(ids, wrong, f.total, f.nonzero, f)[
        "count_rows_off"] == 1
    twice = ids.clone()
    twice[0] = twice[1]
    assert compare.count_checks(twice, cnt, f.total, f.nonzero, f)[
        "count_rows_off"] >= 2
    out = compare.count_checks(ids, cnt, f.total + 2, f.nonzero - 1, f)
    assert (out["count_total_gap"], out["count_nonzero_gap"]) == (2, 1)
