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
from tpujoin_torch.ops import aggregate as agg
from tpujoin_torch.ops import filter as flt
from tpujoin_torch.kernels import (carry_scan, compact, expand, expand_fill,
                                   expand_groups, expand_runs, merge_count,
                                   merge_sort, shift_loop, smem_gather,
                                   stream)

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


def _rle_state(ngroups: int, seed: int):
    """A random RLE state as probe_count and the group heads leave it:
    ``ngroups`` groups of 1-50 runs over a build slice of 1-300 ids each,
    padded past the real rows (runs: offset == total; groups: INT32_MAX)."""
    rng = np.random.default_rng(seed)
    gnb = rng.integers(1, 301, ngroups)
    gnp = rng.integers(1, 51, ngroups)
    glo = np.cumsum(gnb + rng.integers(0, 4, ngroups)) - gnb
    n = int(glo[-1] + gnb[-1]) + 7 if ngroups else 16
    cnt = np.repeat(gnb, gnp)
    lo = np.repeat(glo, gnp)
    offs = np.cumsum(cnt) - cnt
    total = int(cnt.sum())
    goff = offs[np.concatenate([[0], np.cumsum(gnp)[:-1]])] if ngroups else []

    def col(vals, pad, fill):
        return torch.tensor(np.concatenate([vals, np.full(pad, fill)]),
                            dtype=torch.int32, device="cuda")

    k = len(cnt)
    runs = dict(roff=col(offs, 9, total), lo=col(lo, 9, 0),
                sid=col(rng.permutation(k), 9, 0))
    groups = dict(goff=col(goff, 5, IMAX), glo=col(glo, 5, 0),
                  gnb=col(gnb, 5, 0))
    src = torch.from_numpy(rng.permutation(n).astype(np.int32)).cuda()
    return runs, groups, src, k, ngroups, total


@pytest.mark.parametrize("ngroups,extra", [(1, 0), (7, 3), (300, 1001),
                                           (20_000, 5), (0, 100)])
def test_expand_pair_kernels(ngroups, extra):
    """K5, K7a and K7b against their plain versions on random RLE states,
    at ragged capacities and at total = 0."""
    runs, groups, src, k, ng, total = _rle_state(ngroups, ngroups + extra)
    cap = total + extra
    fill_args = (runs["roff"], runs["sid"], groups["goff"], groups["glo"],
                 groups["gnb"], src, k, ng, total, cap)
    runs_args = (runs["roff"], runs["lo"], runs["sid"], src, k, total, cap)
    before = (expand_fill.LAUNCHES, expand_groups.LAUNCHES,
              expand_runs.LAUNCHES)
    fill = expand_fill.expand_fill(*fill_args)
    _equal(fill, expand_fill.expand_fill_plain(*fill_args))
    _equal(expand_groups.expand_groups(*fill_args),
           expand_groups.expand_groups_plain(*fill_args))
    got = expand_runs.expand_runs(*runs_args)
    _equal(got, expand_runs.expand_runs_plain(*runs_args))
    _equal(got, fill)   # the same pairs, from runs or from groups
    assert (fill[0][total:] == -1).all() and (fill[1][total:] == -1).all()
    assert (expand_fill.LAUNCHES, expand_groups.LAUNCHES,
            expand_runs.LAUNCHES) == tuple(b + (cap > 0) for b in before)


def test_merge_join_defaults_to_the_card():
    rng = np.random.default_rng(1)
    bk = rng.integers(1, 257, 4096).astype(np.int32)
    pk = rng.integers(1, 257, 4096).astype(np.int32)
    before = expand_runs.LAUNCHES
    r, s = tpujoin_torch.merge_join(bk, pk, result_pad_multiple=1024)
    assert expand_runs.LAUNCHES == before + 1   # ~16 matches/row: runs
    assert oracle.check_join(bk, pk, r, s) == 1


@pytest.mark.parametrize("chunk", [None, 5000])
def test_merge_join_on_card_matches_cpu(chunk):
    rng = np.random.default_rng(0)
    bk = rng.integers(1, 150_001, 1 << 14).astype(np.int32)
    pk = rng.integers(1, 150_001, 1 << 14).astype(np.int32)
    kw = {"probe_chunk_rows": chunk, "result_pad_multiple": 1024}
    r, s = tpujoin_torch.merge_join(torch.from_numpy(bk).cuda(),
                                    torch.from_numpy(pk).cuda(), **kw)
    cr, cs = tpujoin_torch.merge_join(bk, pk, device="cpu", **kw)

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


def _mask(n: int, sel: float, dtype: str) -> torch.Tensor:
    rng = np.random.default_rng(n + int(sel * 100))
    keep = rng.random(n) < sel
    if dtype == "bool":
        return torch.from_numpy(keep).cuda()
    # an i32 mask: kept rows > 0, the others 0 or negative
    vals = np.where(keep, rng.integers(1, 9, n), rng.integers(-5, 1, n))
    return torch.from_numpy(vals.astype(np.int32)).cuda()


@pytest.mark.parametrize("n,sel", [(0, 0.5), (1, 1.0), (1023, 0.5),
                                   (1025, 0.0), (100_003, 0.5),
                                   (1_000_001, 0.1), (3_000_017, 0.9)])
@pytest.mark.parametrize("dtype", ["bool", "int32"])
@pytest.mark.parametrize("k_cap_of", ["short", "exact", "long"])
def test_compact_ids_kernel(n, sel, dtype, k_cap_of):
    mask = _mask(n, sel, dtype)
    k = int(compact._keep(mask).sum())
    k_cap = {"short": k // 2, "exact": k, "long": k + 1000}[k_cap_of]
    before = compact.IDS_LAUNCHES
    _equal(compact.compact_ids(mask, k_cap),
           compact.compact_ids_plain(mask, k_cap))
    assert compact.IDS_LAUNCHES == before + (n > 0)


@pytest.mark.parametrize("ncols", [1, 3, 6, 8])
@pytest.mark.parametrize("n,sel", [(1025, 0.3), (1_000_003, 0.1),
                                   (2_000_001, 0.6)])
@pytest.mark.parametrize("dtype", ["bool", "int32"])
def test_compact_cols_kernel(ncols, n, sel, dtype):
    mask = _mask(n, sel, dtype)
    rng = np.random.default_rng(ncols)
    cols = [torch.from_numpy(rng.integers(IMIN, IMAX, n, endpoint=True)
                             .astype(np.int32)).cuda() for _ in range(ncols)]
    k = int(compact._keep(mask).sum())
    before = compact.COLS_LAUNCHES
    for k_cap in (k // 3, k + 777):
        got, nz = compact.compact_cols(mask, cols, k_cap)
        want, wnz = compact.compact_cols_plain(mask, cols, k_cap)
        _equal((*got, nz), (*want, wnz))
    assert compact.COLS_LAUNCHES == before + 2


def test_compact_wrappers_refuse_bad_input():
    mask = torch.ones(64, dtype=torch.bool, device="cuda")
    col = torch.arange(64, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        compact.compact_ids(mask.to(torch.uint8), 8)       # mask type
    with pytest.raises(ValueError):
        compact.compact_ids(mask[::2], 8)                  # strided
    with pytest.raises(ValueError):
        compact.compact_cols(mask, [col] * 9, 8)           # > 8 columns
    with pytest.raises(ValueError):
        compact.compact_cols(mask, [col[:63]], 8)          # ragged
    with pytest.raises(ValueError):
        compact.compact_cols(mask, [col.long()], 8)        # column type
    with pytest.raises(ValueError):
        compact.compact_cols(mask.cpu(), [col], 8)         # two devices


def test_filter_on_card_matches_cpu():
    vals = np.random.default_rng(4).uniform(0, 160, 300_001).astype(
        np.float32)
    before = compact.IDS_LAUNCHES
    ids, total = flt.filter_device(vals, 80.0, 1 << 18)    # default: card
    assert ids.is_cuda and compact.IDS_LAUNCHES == before + 1
    cids, ctotal = flt.filter_device(vals, 80.0, 1 << 18, device="cpu")
    assert int(total) == int(ctotal)
    assert torch.equal(ids.cpu(), cids)
    table = {"val": vals, "rowid": np.arange(len(vals), dtype=np.int32)}
    got = tpujoin_torch.filter_table(table, lambda v: v >= 80.0, "val",
                                     return_numpy=True)
    want = tpujoin_torch.filter_table(table, lambda v: v >= 80.0, "val",
                                      device="cpu", return_numpy=True)
    for name in table:
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("n,dom", [(1 << 20, 100_000), (300_007, 7),
                                   (4096, 10**9)])
def test_aggregate_on_card_matches_cpu(n, dom):
    rng = np.random.default_rng(n)
    keys = rng.integers(-dom, dom, n).astype(np.int32)
    vals = rng.integers(IMIN, IMAX, n, endpoint=True).astype(np.int32)
    before = (compact.IDS_LAUNCHES, compact.COLS_LAUNCHES)
    got = tpujoin_torch.group_by_agg(keys, vals)
    assert compact.COLS_LAUNCHES == before[1] + 1
    want = tpujoin_torch.group_by_agg(keys, vals, device="cpu")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    gk, gc = tpujoin_torch.group_by_count(keys)
    assert compact.IDS_LAUNCHES == before[0] + 1
    ok, oc = oracle.group_by_count(keys)
    np.testing.assert_array_equal(gk, ok)
    np.testing.assert_array_equal(gc, oc)
    cap = 1 << 21
    tk, tv = torch.from_numpy(keys).cuda(), torch.from_numpy(vals).cuda()
    for g, w in zip(agg.group_agg_materialize(tk, tv, cap),
                    agg.group_agg_materialize(tk.cpu(), tv.cpu(), cap),
                    strict=True):
        assert torch.equal(g.cpu(), w)


def test_nested_loop_join_on_card():
    rng = np.random.default_rng(5)
    rk = rng.integers(1, 600, 3000).astype(np.int32)
    sk = rng.integers(1, 600, 2000).astype(np.int32)
    before = compact.IDS_LAUNCHES
    r, s = tpujoin_torch.nested_loop_join(rk, sk)          # default: card
    assert compact.IDS_LAUNCHES == before + 1
    assert oracle.check_join(rk, sk, r, s, nested=True) == 1
    cr, cs = tpujoin_torch.nested_loop_join(rk, sk, device="cpu")
    np.testing.assert_array_equal(r, cr)
    np.testing.assert_array_equal(s, cs)


def _full_range(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.integers(IMIN, IMAX, n, endpoint=True).astype(np.int32)
    x[:min(n, 4)] = np.array([IMAX, IMIN, -1, IMAX], np.int32)[:min(n, 4)]
    return torch.from_numpy(x).cuda()


@pytest.mark.parametrize("n", [0, 1, carry_scan.TILE, carry_scan.TILE + 1,
                               3 * carry_scan.TILE + 17, (1 << 22) + 5])
@pytest.mark.parametrize("values", ["ones", "full_range"])
def test_carry_scan_kernel(n, values):
    """The look-back scan at n = 0, one row, one tile, a tile and a row, a
    ragged third tile and ~1000 tiles, with values that wrap."""
    x = (torch.ones(n, dtype=torch.int32, device="cuda") if values == "ones"
         else _full_range(n, n))
    before = carry_scan.LAUNCHES
    want = carry_scan.carry_scan_plain(x)
    for _ in range(2):      # the status words are zeroed before each launch
        _equal((carry_scan.carry_scan(x),), (want,))
    assert carry_scan.LAUNCHES == before + 2 * (n > 0)


@pytest.mark.parametrize("rolls", [0, 1, 4, 20, 1024, 1500])
@pytest.mark.parametrize("tiles", [1, 3, 1000])
def test_shift_loop_kernel(rolls, tiles):
    x = _full_range(tiles * shift_loop.TILE, rolls + tiles)
    before = shift_loop.LAUNCHES
    _equal((shift_loop.shift_loop(x, rolls),),
           (shift_loop.shift_loop_plain(x, rolls),))
    assert shift_loop.LAUNCHES == before + 1


@pytest.mark.parametrize("tbl_n", [1, 1000, 16384])
@pytest.mark.parametrize("n", [0, 1, 65536, 100_003])
def test_smem_gather_kernel(tbl_n, n):
    tbl = _full_range(tbl_n, 9)
    idx = torch.randint(0, tbl_n, (n,), dtype=torch.int32, device="cuda")
    before = smem_gather.LAUNCHES
    _equal((smem_gather.smem_gather(tbl, idx),),
           (smem_gather.smem_gather_plain(tbl, idx),))
    assert smem_gather.LAUNCHES == before + (n > 0)


def test_smem_gather_largest_table():
    limit = smem_gather.max_table_entries(torch.device("cuda"))
    tbl = _full_range(limit, 10)
    idx = torch.randint(0, limit, (1 << 18,), dtype=torch.int32,
                        device="cuda")
    _equal((smem_gather.smem_gather(tbl, idx),),
           (smem_gather.smem_gather_plain(tbl, idx),))
    with pytest.raises(ValueError, match="shared memory"):
        smem_gather.smem_gather(_full_range(limit + 1, 11), idx)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 1027, (1 << 22) + 1])
@pytest.mark.parametrize("offset", [0, 1])
def test_stream_scale_kernel(n, offset):
    """On the i32 extremes, with the vector path (offset 0) and with a
    column that starts off 16-byte alignment (offset 1)."""
    x = _full_range(n + offset, n)[offset:]
    before = stream.LAUNCHES
    got = stream.stream_scale(x)
    _equal((got,), (stream.stream_scale_plain(x),))
    assert stream.LAUNCHES == before + (n > 0)
    ext = torch.tensor([IMAX, IMIN, -1, 0, 1, IMAX - 1, IMIN + 1],
                       dtype=torch.int32, device="cuda")
    assert stream.stream_scale(ext).tolist() == [-2, 0, -2, 0, 2, -4, 2]


def test_probe_wrappers_refuse_bad_input():
    x = torch.arange(2048, dtype=torch.int32, device="cuda")
    for bad in (x[::2], x.long()):
        with pytest.raises(ValueError):
            stream.stream_scale(bad)
        with pytest.raises(ValueError):
            carry_scan.carry_scan(bad)
        with pytest.raises(ValueError):
            smem_gather.smem_gather(x, bad)
    with pytest.raises(ValueError):
        shift_loop.shift_loop(x[:1000], 1)
    with pytest.raises(ValueError):
        smem_gather.smem_gather(x, x.cpu())
