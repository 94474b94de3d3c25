"""tpujoin_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every output is an integer, so equality is exact.

These tests need a CUDA device and skip without one. The file imports no
JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import tpujoin_torch
from tpujoin_torch import oracle
from tpujoin_torch.kernels import compact, expand, merge_count, merge_sort

pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the kernels have no CPU mode")

IMAX = np.iinfo(np.int32).max
IMIN = np.iinfo(np.int32).min


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _sort_keys(dist: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if dist == "uniform":
        return rng.integers(1, 10**9, n).astype(np.int32)
    if dist == "dup8":
        return rng.integers(0, 8, n).astype(np.int32)
    return rng.choice(np.array([IMIN, -1, 0, 1, IMAX - 1, IMAX], np.int32), n)


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 3 * 4096 + 5,
                               (1 << 20) + 3])
@pytest.mark.parametrize("dist", ["uniform", "dup8", "extremes"])
def test_sort_kernels(n, dist):
    keys = torch.from_numpy(_sort_keys(dist, n)).cuda()
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    tile = merge_sort.TILE
    _equal(merge_sort.block_sort(keys, ids),
           merge_sort.segment_sort_plain(keys, ids, tile))
    kb, ib = merge_sort.block_sort(keys, ids)
    _equal(merge_sort.merge_pass(kb, ib, tile),
           merge_sort.segment_sort_plain(kb, ib, 2 * tile))
    _equal(merge_sort.sort_pairs(keys, ids),
           merge_sort.sort_pairs_plain(keys, ids))


@pytest.mark.parametrize("n,m", [(4096, 4096), (0, 300), (1, 1), (1024, 1024),
                                 (5000, 257), (100_003, 1_000_001)])
@pytest.mark.parametrize("spread", [2, 0.5])
def test_merge_count_kernel(n, m, spread):
    rng = np.random.default_rng(n + m)
    hi = max(int(spread * n), 2)
    b = np.sort(rng.integers(1, hi, n)).astype(np.int32)
    p = np.sort(rng.integers(-10, hi + 1000, m)).astype(np.int32)
    b, p = torch.from_numpy(b).cuda(), torch.from_numpy(p).cuda()
    _equal(merge_count.merge_count(b, p), merge_count.merge_count_plain(b, p))


@pytest.mark.parametrize("n,sel", [(0, 0.5), (1, 1.0), (1023, 0.5),
                                   (1025, 0.0), (100_003, 0.095),
                                   (1_000_000, 0.6)])
@pytest.mark.parametrize("k_cap_of", ["short", "exact", "long"])
def test_compact3_kernel(n, sel, k_cap_of):
    rng = np.random.default_rng(n)
    flag = rng.random(n) < sel
    cnt = np.where(flag, rng.integers(1, 6, n), 0).astype(np.int32)
    lo = np.sort(rng.integers(0, 1 << 20, n)).astype(np.int32)
    sid = rng.permutation(n).astype(np.int32)
    k = int(flag.sum())
    k_cap = {"short": k // 2, "exact": k, "long": k + 1000}[k_cap_of]
    cols = [torch.from_numpy(c).cuda() for c in (lo, cnt, sid)]
    _equal(compact.compact3(*cols, k_cap),
           compact.compact3_plain(*cols, k_cap))


@pytest.mark.parametrize("k,max_count", [(1000, 1), (300, 20), (1, 5000),
                                         (3_000_000, 2)])
def test_expand_kernel(k, max_count):
    rng = np.random.default_rng(k)
    counts = rng.integers(1, max_count + 1, k).astype(np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    lo = np.sort(rng.integers(0, 10**6, k)).astype(np.int32)
    sid = rng.permutation(k).astype(np.int32)
    total = int(counts.sum())
    # a zero tail as compaction leaves it: offs == total, lo == sid == 0
    pad = 77
    offsets = np.concatenate([offsets, np.full(pad, total, np.int32)])
    lo = np.concatenate([lo, np.zeros(pad, np.int32)])
    sid = np.concatenate([sid, np.zeros(pad, np.int32)])
    cols = [torch.from_numpy(c).cuda() for c in (offsets, lo, sid)]
    _equal(expand.expand(*cols, total + 1000),
           expand.expand_plain(*cols, total + 1000))


@pytest.mark.parametrize("chunk", [None, 5000])
def test_merge_join_on_card_matches_cpu(chunk):
    rng = np.random.default_rng(0)
    bk = rng.integers(1, 150_001, 1 << 14).astype(np.int32)
    pk = rng.integers(1, 150_001, 1 << 14).astype(np.int32)
    kw = {"probe_chunk_rows": chunk, "result_pad_multiple": 1024}
    r, s = tpujoin_torch.merge_join(torch.from_numpy(bk).cuda(),
                                    torch.from_numpy(pk).cuda(), **kw)
    cr, cs = tpujoin_torch.merge_join(bk, pk, **kw)

    def pairs(a, b):
        return np.sort(a.astype(np.int64) << 32 | b.astype(np.int64))

    np.testing.assert_array_equal(pairs(r, s), pairs(cr, cs))
    assert oracle.check_join(bk, pk, r, s) == 1


def test_wrappers_count_launches_and_refuse_bad_input():
    x = torch.arange(4096, dtype=torch.int32, device="cuda")
    before = merge_count.LAUNCHES
    merge_count.merge_count(x, x)
    assert merge_count.LAUNCHES == before + 1
    with pytest.raises(ValueError):
        merge_count.merge_count(x, x.long())
    with pytest.raises(ValueError):
        merge_count.merge_count(x, x.cpu())
    with pytest.raises(ValueError):
        merge_sort.block_sort(x[::2], x[::2])
