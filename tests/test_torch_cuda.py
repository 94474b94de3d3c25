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
from tpujoin_torch.core import datagen
from tpujoin_torch.ops import aggregate as agg
from tpujoin_torch.ops import filter as flt
from tpujoin_torch.ops import hash_join
from tpujoin_torch.kernels import (carry_scan, compact, expand, expand_fill,
                                   expand_groups, expand_runs, fill_phases,
                                   flat_roll, forward_fill, merge_count,
                                   merge_sort, mosaic, mosaic2, mosaic3,
                                   op_chain, runs_phases, select_chain,
                                   shift_loop, slab_count, smem_gather,
                                   stream)
from tpujoin_torch.probes import (fill_variants, probe_mosaic, probe_mosaic2,
                                  probe_mosaic3, profile_expand_runs)

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
    if dist == "all_equal":
        return np.full(n, 42, np.int32)
    return rng.choice(np.array([IMIN, -1, 0, 1, IMAX - 1, IMAX], np.int32), n)


_TILE = merge_sort.TILE


@pytest.mark.parametrize("n", [0, 1, _TILE - 1, _TILE, _TILE + 1,
                               3 * _TILE + 5, (1 << 20) + 3])
@pytest.mark.parametrize("dist", ["uniform", "dup8", "all_equal",
                                  "extremes"])
def test_sort_kernels(n, dist):
    """The histogram, each digit pass on the keys as they arrive at its
    digit, and the whole sort, each bitwise against its plain version."""
    keys = torch.from_numpy(_sort_keys(dist, n)).cuda()
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    hist = merge_sort.sort_histogram(keys)
    _equal((hist,), (merge_sort.sort_histogram_plain(keys),))
    k, i = keys, ids
    for shift in merge_sort.SHIFTS:
        want = merge_sort.sort_pass_plain(k, i, shift)
        _equal(merge_sort.sort_pass(k, i, shift, hist), want)
        k, i = want
    _equal(merge_sort.sort_pairs(keys, ids),
           merge_sort.sort_pairs_plain(keys, ids))


def _count_keys(spread, n: int, m: int, rng):
    """Sorted (build, probe) keys for test_merge_count_kernel."""
    if spread == "top":
        top = np.array([IMAX - 3, IMAX - 1, IMAX], np.int32)
        b = rng.choice(top, n)
        p = rng.choice(np.append(top, IMAX - 2), m)
    elif spread == "extremes":    # INT32_MIN and INT32_MAX on both sides
        b = rng.choice(np.array([IMIN, IMIN + 1, 0, IMAX - 1, IMAX]), n)
        p = rng.choice(np.array([IMIN, -1, 0, IMAX - 2, IMAX]), m)
    elif spread == "one_run":     # one key's build run over many tiles
        b = np.where(rng.random(n) < 0.9, 50, rng.integers(1, 100, n))
        p = np.where(rng.random(m) < 0.5, 50, rng.integers(0, 101, m))
    elif spread == "zipf":        # zipf_skew's keys, Zipf(1.0) over 1..1e6
        gen = torch.Generator().manual_seed(n + m)
        b = datagen.zipf_keys(gen, n, 1, 10**6).numpy()
        p = datagen.zipf_keys(gen, m, 1, 10**6).numpy()
    else:
        hi = max(int(spread * n), 2)
        b = rng.integers(1, hi, n)
        p = rng.integers(-10, hi + 1000, m)
    return np.sort(b).astype(np.int32), np.sort(p).astype(np.int32)


@pytest.mark.parametrize("n,m", [(4096, 4096), (0, 300), (1, 1), (1024, 1024),
                                 (5000, 257), (100_003, 1_000_001),
                                 (1_000_003, 300), (300, 1_000_003),
                                 (1_000_003, 1_000_001), (0, 0), (7, 0)])
@pytest.mark.parametrize("spread", [2, 0.5, "top", "extremes", "one_run",
                                    "zipf"])
def test_merge_count_kernel(n, m, spread):
    """Keys in [1, spread * n) against [-10, hi + 1000); ("top") keys at
    the top of the i32 range on both sides, INT32_MAX included; both i32
    ends on both sides; one key's build run of ~0.9 n (1M copies at the
    largest n) with its probe copies over many tiles; Zipf(1.0) keys."""
    b, p = _count_keys(spread, n, m, np.random.default_rng(n + m))
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


_XTILE = expand_fill.TILE


@pytest.mark.parametrize("k,max_count", [(1000, 1), (300, 20), (1, 5000),
                                         (3_000_000, 2)])
@pytest.mark.parametrize("pad,extra,start", [
    (77, 1000, 0), (3 * _XTILE + 5, 1000, 0), (3 * _XTILE + 5, _XTILE + 3, 0),
    (0, _XTILE // 2 + 7, 0), (1, -100, 0), (77, 1000, 5)])
def test_expand_kernel(k, max_count, pad, extra, start):
    """Every slot up to capacity, those at or past the total included,
    behind a zero tail as compaction leaves it (offs == total, lo == sid
    == 0) of ``pad`` rows, longer than a tile at 3 * TILE + 5; capacity
    total + ``extra``, so it ends mid-tile or below the total; ``start``
    > 0 puts slots before the first row."""
    rng = np.random.default_rng(k)
    counts = rng.integers(1, max_count + 1, k).astype(np.int32)
    offsets = (np.cumsum(counts) - counts + start).astype(np.int32)
    lo = np.sort(rng.integers(0, 10**6, k)).astype(np.int32)
    sid = rng.permutation(k).astype(np.int32)
    total = int(counts.sum()) + start
    offsets = np.concatenate([offsets, np.full(pad, total, np.int32)])
    lo = np.concatenate([lo, np.zeros(pad, np.int32)])
    sid = np.concatenate([sid, np.zeros(pad, np.int32)])
    cols = [torch.from_numpy(c).cuda() for c in (offsets, lo, sid)]
    cap = max(total + extra, 0)
    _equal(expand.expand(*cols, cap), expand.expand_plain(*cols, cap))


def _rle_state(ngroups: int, seed: int):
    """A random RLE state as probe_count and the group heads leave it:
    ``ngroups`` groups of 1-50 runs over a build slice of 1-300 ids each,
    padded past the real rows (runs: offset == total; groups: INT32_MAX)."""
    rng = np.random.default_rng(seed)
    gnb = rng.integers(1, 301, ngroups)
    return _groups_state(gnb, rng.integers(1, 51, ngroups), rng)


def _groups_state(gnb, gnp, rng, first: int = 0):
    """The RLE state of groups of ``gnp`` runs over build slices of ``gnb``
    ids, its offsets from ``first`` on."""
    ngroups = len(gnb)
    glo = np.cumsum(gnb + rng.integers(0, 4, ngroups)) - gnb
    n = int(glo[-1] + gnb[-1]) + 7 if ngroups else 16
    cnt = np.repeat(gnb, gnp)
    lo = np.repeat(glo, gnp)
    offs = np.cumsum(cnt) - cnt + first
    total = int(cnt.sum()) + first
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


_FILL_TILE = expand_fill.TILE
# states that stress K5's windows, each at a capacity total + extra that
# is no multiple of the tile
WINDOW_STATES = [("one_slot_runs", 777), ("one_group_many_tiles", 5),
                 ("nb_above_tile", 13), ("first_offset", 999),
                 ("total_zero", 3000)]


def _window_state(name: str):
    """(runs, groups, src, nruns, ngroups, total, joined): ``name``'s state,
    and whether expand_runs gives the same pairs on it. one_slot_runs: a
    tile meets TILE + 1 runs, all periods 1; one_group_many_tiles: one
    group over ~47 tiles; nb_above_tile: periods TILE + 1 and 2 TILE + 3;
    first_offset: runs and groups from slot 1500 on, so the slots before
    take the canonical negative phase and no run; total_zero: rows, but
    total 0."""
    rng = np.random.default_rng(len(name))
    if name == "one_slot_runs":
        return (*_groups_state(np.ones(300, int),
                               rng.integers(1, 201, 300), rng), True)
    if name == "one_group_many_tiles":
        return (*_groups_state(np.array([97]), np.array([1000]), rng), True)
    if name == "nb_above_tile":
        nb = np.array([_FILL_TILE + 1, 2 * _FILL_TILE + 3, 1,
                       _FILL_TILE + 1, 5])
        return (*_groups_state(nb, np.array([3, 2, 7, 1, 4]), rng), True)
    if name == "first_offset":
        return (*_groups_state(rng.integers(1, 301, 50),
                               rng.integers(1, 51, 50), rng, first=1500),
                False)
    assert name == "total_zero"
    *state, _ = _groups_state(rng.integers(1, 301, 50),
                              rng.integers(1, 51, 50), rng)
    return (*state, 0, True)


def _state(state, extra: int):
    """_rle_state(state, state + extra) for a group count, else the window
    state of that name; with ``joined``."""
    if isinstance(state, str):
        return _window_state(state)
    return (*_rle_state(state, state + extra), True)


@pytest.mark.parametrize("state,extra", [(1, 0), (7, 3), (300, 1001),
                                         (20_000, 5), (0, 100)]
                         + WINDOW_STATES)
def test_expand_pair_kernels(state, extra):
    """K5, K7a and K7b against their plain versions on random RLE states
    and on the window states, at ragged capacities and at total = 0."""
    runs, groups, src, k, ng, total, joined = _state(state, extra)
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
    if joined:
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


@pytest.mark.parametrize("chunk", [1, 2, 777])
def test_chunked_merge_join_on_card_with_top_keys(chunk):
    """Build keys 0x7FFFFFFE and INT32_MAX join only real probe rows,
    chunked, on the card as on the CPU."""
    rng = np.random.default_rng(chunk)
    top = np.array([0x7FFFFFFE, IMAX, 5, 9], np.int32)
    bk = rng.choice(top, 3000)
    pk = rng.choice(np.append(top, 7), 2000)
    kw = {"probe_chunk_rows": chunk, "result_pad_multiple": 1024}
    r, s = tpujoin_torch.merge_join(torch.from_numpy(bk).cuda(),
                                    torch.from_numpy(pk).cuda(), **kw)
    cr, cs = tpujoin_torch.merge_join(bk, pk, device="cpu", **kw)

    def pairs(a, b):
        return np.sort(a.astype(np.int64) << 32 | b.astype(np.int64))

    np.testing.assert_array_equal(pairs(r, s), pairs(cr, cs))
    assert (s < len(pk)).all()
    assert oracle.check_join(bk, pk, r, s) == 1
    r, s = tpujoin_torch.merge_join(np.array([0x7FFFFFFE, 5], np.int32),
                                    np.array([5, 2, 3], np.int32),
                                    probe_chunk_rows=2)
    assert (r.tolist(), s.tolist()) == ([1], [0])


def test_wrappers_count_launches_and_refuse_bad_input():
    x = torch.arange(4096, dtype=torch.int32, device="cuda")
    before = merge_count.LAUNCHES
    merge_count.merge_count(x, x)
    assert merge_count.LAUNCHES == before + 1
    with pytest.raises(ValueError):
        merge_count.merge_count(x, x.long())
    with pytest.raises(ValueError):
        merge_count.merge_count(x, x.cpu())
    before = merge_sort.HIST_LAUNCHES, merge_sort.PASS_LAUNCHES
    merge_sort.sort_pairs(x, x)
    assert (merge_sort.HIST_LAUNCHES, merge_sort.PASS_LAUNCHES) == (
        before[0] + 1, before[1] + 4)
    hist = merge_sort.sort_histogram(x)
    with pytest.raises(ValueError):
        merge_sort.sort_histogram(x[::2])
    with pytest.raises(ValueError):
        merge_sort.sort_pass(x[::2], x[::2], 0, hist)
    with pytest.raises(ValueError):
        merge_sort.sort_pass(x, x, 4, hist)
    with pytest.raises(ValueError):
        merge_sort.sort_pass(x, x, 0, hist[:2])
    with pytest.raises(ValueError):
        merge_sort.sort_pass(x, x, 0, hist, out=(x, torch.empty_like(x)))


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


MC_STRATEGIES = ["fat512", "fatc512", "fatc256", "fatc128", "diag128",
                 "quad256", "diag4"]


@pytest.mark.parametrize("strategy", MC_STRATEGIES)
@pytest.mark.parametrize("n,m,dist", [(0, 300, "dups"), (1, 1, "dups"),
                                      (1024, 1024, "dups"),
                                      (2500, 3100, "dups"),
                                      (100_003, 300_001, "wide"),
                                      (5000, 7000, "extremes")])
def test_slab_count_kernel(strategy, n, m, dist):
    """merge_count_v at ragged sizes, keys with long duplicate runs, spread
    over the i32 range, or at its extremes (below INT32_MAX, the pad)."""
    rng = np.random.default_rng(n + m)
    if dist == "dups":
        b, p = rng.integers(0, 300, n), rng.integers(-5, 320, m)
    elif dist == "wide":
        b, p = (rng.integers(IMIN, IMAX - 1, x) for x in (n, m))
    else:
        ext = np.array([IMIN, IMIN + 1, -1, 0, IMAX - 2, IMAX - 1])
        b, p = rng.choice(ext, n), rng.choice(ext, m)
    b = torch.from_numpy(np.sort(b).astype(np.int32)).cuda()
    p = torch.from_numpy(np.sort(p).astype(np.int32)).cuda()
    before = slab_count.LAUNCHES
    _equal(slab_count.merge_count_v(b, p, strategy),
           slab_count.merge_count_v_plain(b, p))
    assert slab_count.LAUNCHES == before + (m > 0)


def test_slab_count_lo_above_every_build_key():
    b = torch.ones(1024, dtype=torch.int32, device="cuda")
    p = torch.full((1024,), 2, dtype=torch.int32, device="cuda")
    for strategy in ("fat512", "diag128"):
        lo, cnt = slab_count.merge_count_v(b, p, strategy)
        assert (lo == 1024).all() and not cnt.any()


def _uneven_runs(seed: int):
    """~800 runs of 1-40 slots with random build starts and a full-range
    source, slab bases that make raw source offsets negative."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 41, 800)
    offs = np.cumsum(counts) - counts
    k = len(counts)
    total = int(offs[-1] + counts[-1]) - 300
    capacity = total + 5000
    steps = -(-capacity // runs_phases.STEP)
    cols = [np.full(runs_phases.META, IMAX), np.zeros(runs_phases.META),
            np.zeros(runs_phases.META)]
    cols[0][:k], cols[1][:k], cols[2][:k] = (offs, rng.integers(0, 6000, k),
                                             rng.permutation(k))
    cols += [rng.integers(IMIN, IMAX, 12288, endpoint=True),
             np.zeros(steps), np.arange(steps) % 3 * 2048 + 1024]
    cols = [torch.from_numpy(c.astype(np.int32)).cuda() for c in cols]
    return cols, k, total, capacity


@pytest.mark.parametrize("variant", runs_phases.VARIANTS)
@pytest.mark.parametrize("case", ["gapless", "uneven"])
def test_run_variant_kernel(variant, case):
    if case == "gapless":
        *cols, k, capacity = profile_expand_runs.inputs(30_000,
                                                        torch.device("cuda"))
        total = capacity
    else:
        cols, k, total, capacity = _uneven_runs(3)
    runs_phases.check_bases(cols[0], cols[3], cols[4], cols[5], k, capacity)
    before = runs_phases.LAUNCHES
    _equal(runs_phases.run_variant(*cols, k, total, capacity, variant),
           runs_phases.run_variant_plain(*cols, k, total, capacity, variant))
    assert runs_phases.LAUNCHES == before + 1


def _marks(n: int, every: int, seed: int) -> torch.Tensor:
    """n slots of -1 and other negatives, with markers (values up to
    INT32_MAX) about ``every`` slots apart (none when every is 0)."""
    rng = np.random.default_rng(seed)
    mark = rng.integers(-9, 0, n).astype(np.int32)
    if every:
        at = rng.integers(0, n, n // every)
        mark[at] = rng.integers(0, IMAX, len(at), endpoint=True)
    return torch.from_numpy(mark.reshape(-1, 128)).cuda()


@pytest.mark.parametrize("step", [8192, 16384, 65536])
@pytest.mark.parametrize("tiles", [1, 3, 200])
@pytest.mark.parametrize("every", [0, 100, 50_000, 3_000_000])
def test_fill_forward_kernel(step, tiles, every):
    """Dense markers, markers rarer than a tile (tiles pass the value
    before them on), and none at all (every slot -1)."""
    mark = _marks(step * tiles, every, step + tiles + every)
    before = forward_fill.LAUNCHES
    for _ in range(2):      # the status words are zeroed before each launch
        _equal((forward_fill.fill_forward(mark, step),),
               (forward_fill.fill_forward_plain(mark, step),))
    assert forward_fill.LAUNCHES == before + 2


def test_scatter_markers_on_card():
    rng = np.random.default_rng(1)
    counts = rng.integers(1, 50, 30_000)
    offs = torch.from_numpy((np.cumsum(counts) - counts).astype(np.int32))
    sid = torch.from_numpy(rng.permutation(30_000).astype(np.int32))
    cap = 1 << 20
    got = forward_fill.scatter_markers(offs.cuda(), sid.cuda(), 25_000, cap)
    want = forward_fill.scatter_markers(offs, sid, 25_000, cap)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("variant", list(fill_phases.VARIANTS))
@pytest.mark.parametrize("state,extra", [(1, 0), (300, 1001), (20_000, 5),
                                         (0, 100)] + WINDOW_STATES)
@pytest.mark.parametrize("step", [1024, 16384])
def test_expand_fill_v_kernel(variant, state, extra, step):
    runs, groups, src, k, ng, total, _ = _state(state, extra)
    args = (runs["roff"], runs["sid"], groups["goff"], groups["glo"],
            groups["gnb"], src, k, ng, total, total + extra)
    before = fill_phases.LAUNCHES
    got = fill_phases.expand_fill_v(*args, step, variant)
    _equal(got, fill_phases.expand_fill_v_plain(*args, step, variant))
    assert fill_phases.LAUNCHES == before + (total + extra > 0)
    if fill_phases.VARIANTS[variant] == 0 and total + extra:
        cap = total + extra
        _equal([c[:cap] for c in got],
               expand_fill.expand_fill(*args[:-1], cap))


def test_expand_fill_v_on_the_program_layout():
    *state, cap = fill_variants.inputs(30, torch.device("cuda"))
    r, s = fill_phases.expand_fill_v(*state, cap, 32768, "full")
    assert fill_variants.check_analytic(r, s, state[-1])


def test_variant_wrappers_refuse_bad_input():
    x = torch.arange(4096, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        slab_count.merge_count_v(x, x, "fat256")
    with pytest.raises(ValueError):
        slab_count.merge_count_v(x, x.cpu(), "fat512")
    with pytest.raises(ValueError):
        forward_fill.fill_forward(x.reshape(-1, 128)[:, ::2], 8192)
    with pytest.raises(ValueError):
        forward_fill.fill_forward(torch.zeros(64, 128, dtype=torch.int32,
                                              device="cuda"), 16384)


@pytest.mark.parametrize("kind", op_chain.KINDS)
@pytest.mark.parametrize("rows", op_chain.ROWS)
@pytest.mark.parametrize("ops,steps", [(64, 3), (5, 2), (0, 1)])
def test_op_chain_kernel(kind, rows, ops, steps):
    """Every R, the cluster of two at R = 512 included, on full-range
    tiles: 64 ops (the row kinds move only at R >= 256), 5 ops (they move
    at every R), and none; shifts 5, a negative one and INT32_MAX."""
    x = _full_range(rows * op_chain.LANES, rows + ops).view(rows, -1)
    before = op_chain.LAUNCHES
    for sh in (5, -3, IMAX):
        _equal((op_chain.op_chain(x, sh, kind, ops, steps),),
               (op_chain.op_chain_plain(x, sh, kind, ops, steps),))
    assert op_chain.LAUNCHES == before + 3


@pytest.mark.parametrize("rows", [1, 8, 128])
@pytest.mark.parametrize("ops", [0, 1, 33])
@pytest.mark.parametrize("blocks", [1, 1000])
def test_select_chain_kernel(rows, ops, blocks):
    x = _full_range(blocks * rows * select_chain.LANES, rows + ops)
    shifts = _full_range(max(ops, 1), ops)
    shifts[1::2] = torch.arange(1, shifts[1::2].numel() + 1,
                                dtype=torch.int32, device="cuda") * 37
    before = select_chain.LAUNCHES
    _equal((select_chain.select_chain(x, shifts, ops, rows),),
           (select_chain.select_chain_plain(x, shifts, ops, rows),))
    assert select_chain.LAUNCHES == before + 1


SHIFT_SETS = {"program": [37, 74, 111, 148, 185, 222],
              "negative": [-1, -130, -1024, -1500, IMIN],
              "large": [1024, 1500, IMAX, 1023, 0]}


@pytest.mark.parametrize("shifts", list(SHIFT_SETS))
@pytest.mark.parametrize("rolls", [0, 1, 5])
@pytest.mark.parametrize("steps", [1, 1000])
def test_flat_roll_kernel(shifts, rolls, steps):
    x = _full_range(steps * flat_roll.STEP, steps + rolls)
    ks = torch.tensor(SHIFT_SETS[shifts], dtype=torch.int32, device="cuda")
    before = flat_roll.LAUNCHES
    got = flat_roll.flat_roll(x, ks, rolls)
    _equal((got,), (flat_roll.flat_roll_plain(x, ks, rolls),))
    assert flat_roll.LAUNCHES == before + 1
    if rolls == 1:
        want = torch.roll(x.view(-1, flat_roll.TILE), SHIFT_SETS[shifts][0] %
                          flat_roll.TILE, 1).reshape(-1)
        _equal((got,), (want,))


def test_cost_wrappers_refuse_bad_input():
    x = torch.zeros(2 * flat_roll.STEP, dtype=torch.int32, device="cuda")
    s = torch.arange(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        flat_roll.flat_roll(x[:flat_roll.STEP + flat_roll.TILE], s, 1)
    with pytest.raises(ValueError):
        flat_roll.flat_roll(x, s.cpu(), 1)
    with pytest.raises(ValueError):
        select_chain.select_chain(x[:-128], s, 1, 8)
    with pytest.raises(ValueError):
        select_chain.select_chain(x[1:1 + 1024], s, 1, 8)   # misaligned
    with pytest.raises(ValueError):
        select_chain.select_chain(x, s, 5, 8)
    tile = x[:16 * op_chain.LANES].view(16, -1)
    with pytest.raises(ValueError):
        op_chain.op_chain(x[:24 * op_chain.LANES].view(24, -1), 5, "select")
    with pytest.raises(ValueError):     # not contiguous
        op_chain.op_chain(x[:32 * op_chain.LANES].view(32, -1)[::2], 5,
                          "select")
    with pytest.raises(ValueError):
        op_chain.op_chain(tile, 5, "roll_diag")


# capability-probe kernel -> (its module, its counter's prefix, its program)
MOSAIC = {"roll": (mosaic, "ROLL", probe_mosaic),
          "smem_dyn": (mosaic, "SMEM_DYN", probe_mosaic),
          "vmem_dyn": (mosaic, "VMEM_DYN", probe_mosaic),
          "fori": (mosaic, "FORI", probe_mosaic),
          "smem_block": (mosaic, "SMEM_BLOCK", probe_mosaic),
          "hbm_to_smem": (mosaic2, "HBM_TO_SMEM", probe_mosaic2),
          "dyn_vec_load": (mosaic2, "DYN_VEC_LOAD", probe_mosaic2),
          "sublane_roll": (mosaic3, "SUBLANE_ROLL", probe_mosaic3),
          "row_dma_2d": (mosaic3, "ROW_DMA_2D", probe_mosaic3),
          "flat_rotate": (mosaic3, "FLAT_ROTATE", probe_mosaic3)}


@pytest.mark.parametrize("name,edge", [
    (name, edge) for name, (_, _, program) in MOSAIC.items()
    for edge in [None] + program.EDGES[name]])
def test_mosaic_kernel(name, edge):
    """Each capability-probe kernel at its program's input (edge None) and,
    on full-range data, at the scalars of its program's EDGES."""
    mod, prefix, program = MOSAIC[name]
    args = program.inputs("cuda")[name]
    if edge is not None:
        args = [_full_range(t.numel(), len(edge) + t.numel()).view(t.shape)
                for t in args[:-1]]
        args.append(torch.tensor(edge, dtype=torch.int32, device="cuda"))
    before = getattr(mod, f"{prefix}_LAUNCHES")
    got = getattr(mod, name)(*args)
    _equal((got,), (getattr(mod, f"{name}_plain")(*args),))
    assert getattr(mod, f"{prefix}_LAUNCHES") == before + 1


@pytest.mark.parametrize("row", [40, 0, 1, 8, 223, 224, -1, -31, -32, 225,
                                 255, 256, IMIN, IMAX])
def test_row_dma_2d_kernel(row):
    """row_dma_2d's direct load at every first row that
    tests/test_torch_probe_mosaic.py holds on the CPU, on full-range
    data."""
    x = _full_range(mosaic3.RD_X_ROWS * mosaic3.LANES, 7).view(
        mosaic3.RD_X_ROWS, -1)
    s = torch.tensor([row], dtype=torch.int32, device="cuda")
    _equal((mosaic3.row_dma_2d(x, s),), (mosaic3.row_dma_2d_plain(x, s),))


def test_mosaic_wrappers_refuse_bad_input():
    """A copy's source off a 16-byte boundary, scalars on the CPU."""
    big = torch.zeros(256 * 128 + 4, dtype=torch.int32, device="cuda")
    s = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        mosaic2.hbm_to_smem(big[1:1 + mosaic2.HS_N], s)
    with pytest.raises(ValueError, match="aligned"):
        mosaic3.row_dma_2d(big[1:1 + 256 * 128].view(256, 128), s[:1])
    mosaic2.hbm_to_smem(big[4:4 + mosaic2.HS_N], s)     # 16 bytes in
    with pytest.raises(ValueError):
        mosaic.roll(big[:1024].view(1, 1024), s[:1].cpu())
    with pytest.raises(ValueError):
        mosaic3.flat_rotate(big[:4096].view(32, 128).cpu(), s[:1])


@pytest.mark.parametrize("n,m,dom,pad", [(4096, 4096, 64, 1000),
                                         (1 << 16, 70_001, 3000, 1 << 20),
                                         (3000, 5000, 10, 8192 * 3 + 5)])
def test_v1_dense_materialize_on_card_matches_cpu(n, m, dom, pad):
    """v1's dense materialize (capacity >= probe rows) on the card:
    fill_forward launched on the row markers, the pairs bitwise equal to
    the CPU path's (K1 is bitwise its plain version, so both builds agree),
    at capacities that are no multiple of fill_forward's tile."""
    rng = np.random.default_rng(n + m)
    bk = rng.integers(1, dom + 1, n).astype(np.int32)
    pk = rng.integers(1, dom + 1, m).astype(np.int32)
    before = forward_fill.LAUNCHES
    r, s = tpujoin_torch.hash_join(bk, pk, result_pad_multiple=pad)
    assert forward_fill.LAUNCHES == before + 1
    cr, cs = tpujoin_torch.hash_join(bk, pk, device="cpu",
                                     result_pad_multiple=pad)
    np.testing.assert_array_equal(r, cr)
    np.testing.assert_array_equal(s, cs)
    assert oracle.check_join(bk, pk, r, s) == 1
    ht = hash_join.build(torch.from_numpy(bk).cuda())
    lo, counts = hash_join.probe_count(ht, torch.from_numpy(pk).cuda())
    offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    mark = hash_join.row_markers(offsets, counts, len(r) + 17)
    _equal((forward_fill.fill_forward(mark, hash_join.FILL_STEP),),
           (forward_fill.fill_forward_plain(mark, hash_join.FILL_STEP),))


@pytest.mark.parametrize("dom", [5, 3000, 10**9])
def test_match_split_on_card_matches_cpu(dom):
    """semi, anti and left-outer on the card: compact_ids launched on the
    matched flag and its complement, each result bitwise the CPU path's
    (left outer: its pairs as a multiset, its null tail bitwise)."""
    rng = np.random.default_rng(dom)
    bk = rng.integers(1, dom + 1, 20_000).astype(np.int32)
    pk = rng.integers(1, dom + 1, 30_001).astype(np.int32)
    before = compact.IDS_LAUNCHES
    semi = tpujoin_torch.semi_join(bk, pk)
    assert compact.IDS_LAUNCHES - before == (1 if len(semi) in (0, 30_001)
                                             else 2)
    np.testing.assert_array_equal(semi, tpujoin_torch.semi_join(
        bk, pk, device="cpu"))
    np.testing.assert_array_equal(
        tpujoin_torch.anti_join(bk, pk),
        tpujoin_torch.anti_join(bk, pk, device="cpu"))
    r, s = tpujoin_torch.left_outer_join(bk, pk, result_pad_multiple=4096)
    cr, cs = tpujoin_torch.left_outer_join(bk, pk, device="cpu",
                                           result_pad_multiple=4096)
    k = int((r >= 0).sum())
    np.testing.assert_array_equal(s[k:], cs[k:])
    np.testing.assert_array_equal(np.sort(r[:k].astype(np.int64) << 32
                                          | s[:k]),
                                  np.sort(cr[:k].astype(np.int64) << 32
                                          | cs[:k]))


@pytest.mark.parametrize("keep", [0.0, 0.3, 1.0])
def test_pushdown_compact3_on_card_matches_cpu(keep):
    """The pushdown's compaction of (candidate key, row id) on K3, bitwise
    its plain version's, with keys at the sentinels' edge."""
    from tpujoin_torch.ops import multi_join
    rng = np.random.default_rng(7)
    n = 100_003
    cols = {"k": rng.choice(np.array([IMAX, IMAX - 1, IMAX - 2, 5],
                                     np.int32), n),
            "v": rng.random(n).astype(np.float32)}
    on_card = tpujoin_torch.Table.from_numpy(cols, "cuda")
    on_cpu = tpujoin_torch.Table.from_numpy(cols, "cpu")
    before = compact.LAUNCHES
    got = multi_join._push(on_card, lambda v: v < keep, "v",
                           multi_join.S_PAD_KEY, ["k"], 4096)
    want = multi_join._push(on_cpu, lambda v: v < keep, "v",
                            multi_join.S_PAD_KEY, ["k"], 4096)
    if keep == 0.0:
        assert got == want == (None, None)
        return
    assert compact.LAUNCHES == before + 1
    _equal(got, tuple(w.cuda() for w in want))
