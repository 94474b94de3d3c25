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
from tpujoin_torch import oracle, trace
from tpujoin_torch.core import datagen
from tpujoin_torch.ops import aggregate as agg
from tpujoin_torch.ops import filter as flt
from tpujoin_torch.ops import hash_join
from tpujoin_torch.kernels import (carry_scan, compact, expand, expand_fill,
                                   expand_groups, expand_runs, fill_phases,
                                   flat_roll, forward_fill, merge_count,
                                   merge_sort, mosaic, mosaic2, mosaic3,
                                   op_chain, range_search, runs_phases,
                                   select_chain, shift_loop, slab_count,
                                   smem_gather, stream)
from tpujoin_torch.probes import (fill_variants, probe_mosaic, probe_mosaic2,
                                  probe_mosaic3, profile_expand_runs)
from tpujoin_torch.trace import launches
from tpujoin_torch.utils.shapes import round_up

from expand_cases import expand_case, previous_expand_path
from range_cases import CASES as RANGE_CASES, range_case, two_searchsorted

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


def _rows_want(keys):
    ids = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    return merge_sort.sort_pairs(keys, ids)


@pytest.mark.parametrize("n", [0, 1, _TILE - 1, _TILE, _TILE + 1,
                               5 * _TILE + 3])
def test_sort_rows_kernels(n):
    """The iota pass and sort_rows on the i32 extremes, a ragged last tile
    among them, bitwise against their plain versions and against
    sort_pairs of the row numbers: no pad pair takes a real row's id."""
    keys = torch.from_numpy(_sort_keys("extremes", n)).cuda()
    hist = merge_sort.sort_histogram(keys)
    _equal(merge_sort.sort_pass_iota(keys, hist),
           merge_sort.sort_pass_iota_plain(keys))
    got = merge_sort.sort_rows(keys)
    _equal(got, merge_sort.sort_rows_plain(keys))
    _equal(got, _rows_want(keys))


def test_sort_rows_at_full_width():
    """sort_rows on 100M uniform keys, the build side of ref_low, bitwise
    its plain version and sort_pairs of the row numbers."""
    g = torch.Generator(device="cuda")
    g.manual_seed(20)
    keys = torch.randint(1, 10**9 + 1, (100_000_000,), generator=g,
                         device="cuda", dtype=torch.int32)
    got = merge_sort.sort_rows(keys)
    _equal(got, merge_sort.sort_rows_plain(keys))
    _equal(got, _rows_want(keys))


@pytest.mark.parametrize("entry", ["tj_sort_pass_iota", "tj_sort_pass"])
def test_sort_passes_refuse_n_past_int32(entry):
    """A pass writes i32 output indices: n > INT32_MAX is refused before
    anything launches (the pointers are never read)."""
    from tpujoin_torch.kernels import _build
    x = torch.zeros(4096, dtype=torch.int32, device="cuda")
    hist = merge_sort.sort_histogram(x)
    n = IMAX + 1
    words = (n + _TILE - 1) // _TILE * merge_sort.RADIX + 1
    scratch = torch.zeros(1, dtype=torch.int64, device="cuda")
    ptrs = ((x.data_ptr(),) * 3 if entry == "tj_sort_pass_iota"
            else (x.data_ptr(),) * 4)
    rest = ((n, hist.data_ptr()) if entry == "tj_sort_pass_iota"
            else (n, 0, hist.data_ptr()))
    before = launches[entry]
    with pytest.raises(RuntimeError, match="invalid argument"):
        _build.call(entry, x.device, *ptrs, *rest, scratch.data_ptr(), words)
    assert launches[entry] == before


def test_v2_join_makes_its_ids_in_the_sort():
    """A v2 join sorts both sides with sort_rows: one iota pass and three
    id passes a side; a distributed join's sorts, whose ids are pads or
    positions, take sort_pairs and no iota pass."""
    from tpujoin_torch.parallel import shuffle_join as sj
    from tpujoin_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(5)
    bk = torch.from_numpy(rng.integers(1, 5000, 20_000).astype(np.int32))
    pk = torch.from_numpy(rng.integers(1, 5000, 30_000).astype(np.int32))
    entries = ("tj_sort_pass_iota", "tj_sort_pass", "tj_sort_histogram")
    before = [launches[e] for e in entries]
    r, s = tpujoin_torch.merge_join(bk.cuda(), pk.cuda())
    assert [launches[e] - b for e, b in zip(entries, before)] == [2, 6, 2]
    assert oracle.check_join(bk.numpy(), pk.numpy(), r, s) == 1
    before = [launches[e] for e in entries]
    sj.distributed_hash_join(bk.numpy(), pk.numpy(),
                             mesh=make_mesh(4, device="cuda"))
    assert launches["tj_sort_pass_iota"] == before[0]
    assert launches["tj_sort_pass"] > before[1]


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
    # expand_fill and expand_groups share K5's entry: each call is counted
    # on its own
    counted = []
    for fn, args, entry in (
            (expand_fill.expand_fill, fill_args, "tj_expand_fill"),
            (expand_groups.expand_groups, fill_args, "tj_expand_fill"),
            (expand_runs.expand_runs, runs_args, "tj_expand_runs")):
        before = launches[entry]
        counted.append((fn(*args), launches[entry] - before))
    (fill, n_fill), (groups, n_groups), (got, n_runs) = counted
    _equal(fill, expand_fill.expand_fill_plain(*fill_args))
    _equal(groups, expand_groups.expand_groups_plain(*fill_args))
    _equal(got, expand_runs.expand_runs_plain(*runs_args))
    if joined:
        _equal(got, fill)   # the same pairs, from runs or from groups
    assert (fill[0][total:] == -1).all() and (fill[1][total:] == -1).all()
    assert (n_fill, n_groups, n_runs) == (cap > 0,) * 3


RUNS_CASES = ["long_runs", "one_slot", "below_total", "past_ends", "no_runs"]


def _runs_case(name: str):
    """K7b's inputs on the card: (offs, lo, sid, src, nonzero, total,
    capacity), 9 pad runs past the real ones (offset == total). long_runs:
    runs longer than a tile, one across 40 tiles; one_slot: 2^16 one-slot
    runs, so each tile meets TILE + 1 runs; below_total: the capacity ends
    3 tiles and 7 slots short of the total; past_ends: source indices below
    0 and past n, the first two runs' beyond the i32 range; no_runs:
    nonzero 0 under a total of 5000. Every capacity but below_total's is
    the total plus half a tile and 5."""
    rng = np.random.default_rng(len(name))
    t, nsrc = _FILL_TILE, 1 << 16
    counts = {"long_runs": np.array([t + 5, 3, 40 * t + 17, 2 * t, 1, t - 1]),
              "one_slot": np.ones(1 << 16, np.int64),
              "below_total": rng.integers(1, 50, 5000),
              "past_ends": rng.integers(1, 3 * t, 300),
              "no_runs": np.zeros(0, np.int64)}[name]
    k = len(counts)
    total = int(counts.sum()) if k else 5000
    offs = np.cumsum(counts) - counts
    lo = rng.integers(0, nsrc - 3 * t, k)
    if name == "one_slot":
        lo = rng.integers(-8, nsrc + 8, k)
    if name == "past_ends":
        lo[::3] = rng.integers(-3 * t, 0, len(lo[::3]))
        lo[1::3] = rng.integers(nsrc - 8, nsrc + 8, len(lo[1::3]))
        lo[:2] = [IMIN, IMAX]
    capacity = {"below_total": total - 3 * t - 7}.get(name, total + t // 2 + 5)

    def col(vals, fill):
        return torch.tensor(np.concatenate([vals, np.full(9, fill)]),
                            dtype=torch.int32, device="cuda")

    src = torch.from_numpy(rng.permutation(nsrc).astype(np.int32)).cuda()
    return (col(offs, total), col(lo, 0), col(rng.permutation(k), 0), src,
            k, total, capacity)


@pytest.mark.parametrize("name", RUNS_CASES)
def test_expand_runs_kernel(name):
    """K7b against its plain version: long runs, one-slot runs, a capacity
    below the total and off the tile, a source index past both ends of
    src, and no run."""
    args = _runs_case(name)
    before = launches["tj_expand_runs"]
    got = expand_runs.expand_runs(*args)
    _equal(got, expand_runs.expand_runs_plain(*args))
    assert launches["tj_expand_runs"] == before + 1
    if name == "past_ends":   # the case reaches outside src
        assert (got[0][:args[5]] == -1).any()


def test_merge_join_defaults_to_the_card():
    rng = np.random.default_rng(1)
    bk = rng.integers(1, 257, 4096).astype(np.int32)
    pk = rng.integers(1, 257, 4096).astype(np.int32)
    before = launches["tj_expand_runs"]
    r, s = tpujoin_torch.merge_join(bk, pk, result_pad_multiple=1024)
    assert launches["tj_expand_runs"] == before + 1   # ~16 matches/row: expand
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
    before = launches["tj_merge_count"]
    merge_count.merge_count(x, x)
    assert launches["tj_merge_count"] == before + 1
    with pytest.raises(ValueError):
        merge_count.merge_count(x, x.long())
    with pytest.raises(ValueError):
        merge_count.merge_count(x, x.cpu())
    before = launches["tj_sort_histogram"], launches["tj_sort_pass"]
    merge_sort.sort_pairs(x, x)
    assert (launches["tj_sort_histogram"], launches["tj_sort_pass"]) == (
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
    before = launches["tj_compact_ids"]
    _equal(compact.compact_ids(mask, k_cap),
           compact.compact_ids_plain(mask, k_cap))
    assert launches["tj_compact_ids"] == before + (n > 0)


@pytest.mark.parametrize("n", [1, 15, 16, 17, (1 << 20) + 3])
@pytest.mark.parametrize("fill", ["random", "zero", "all"])
@pytest.mark.parametrize("dtype", ["bool", "int32"])
def test_compact_ids_scan_kernel(n, fill, dtype):
    """K6a's scan at lengths around one 16-byte load and past a tile, on
    all-zero and all-set masks (an int32 one holding negative unset
    values), k_cap below, at and above the count."""
    mask = _mask(n, {"random": 0.5, "zero": 0.0, "all": 1.0}[fill], dtype)
    k = int(compact._keep(mask).sum())
    before = launches["tj_compact_ids"]
    for k_cap in (k // 2, k, k + 21):
        _equal(compact.compact_ids(mask, k_cap),
               compact.compact_ids_plain(mask, k_cap))
    assert launches["tj_compact_ids"] == before + 3


@pytest.mark.parametrize("offset", range(1, 16))
@pytest.mark.parametrize("dtype", ["bool", "int32"])
def test_compact_ids_on_a_view(offset, dtype):
    """K6a on ``mask[offset:]``: a view that starts off its 16-byte
    boundary (bool: at byte offset 1-15)."""
    base = _mask(100_000 + offset, 0.4, dtype)
    mask = base[offset:]
    assert mask.data_ptr() % 16 == offset * mask.element_size() % 16
    k = int(compact._keep(mask).sum())
    for k_cap in (k // 3, k + 5):
        _equal(compact.compact_ids(mask, k_cap),
               compact.compact_ids_plain(mask, k_cap))


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
    before = launches["tj_compact_cols"]
    for k_cap in (k // 3, k + 777):
        got, nz = compact.compact_cols(mask, cols, k_cap)
        want, wnz = compact.compact_cols_plain(mask, cols, k_cap)
        _equal((*got, nz), (*want, wnz))
    assert launches["tj_compact_cols"] == before + 2


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
    before = launches["tj_compact_ids"]
    ids, total = flt.filter_device(vals, 80.0, 1 << 18)    # default: card
    assert ids.is_cuda and launches["tj_compact_ids"] == before + 1
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
    before = (launches["tj_compact_ids"], launches["tj_compact_cols"])
    got = tpujoin_torch.group_by_agg(keys, vals)
    assert launches["tj_compact_cols"] == before[1] + 1
    want = tpujoin_torch.group_by_agg(keys, vals, device="cpu")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    gk, gc = tpujoin_torch.group_by_count(keys)
    assert launches["tj_compact_ids"] == before[0] + 1
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
    before = launches["tj_compact_ids"]
    r, s = tpujoin_torch.nested_loop_join(rk, sk)          # default: card
    assert launches["tj_compact_ids"] == before + 1
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
    before = launches["tj_carry_scan"]
    want = carry_scan.carry_scan_plain(x)
    for _ in range(2):      # the status words are zeroed before each launch
        _equal((carry_scan.carry_scan(x),), (want,))
    assert launches["tj_carry_scan"] == before + 2 * (n > 0)


@pytest.mark.parametrize("rolls", [0, 1, 4, 20, 1024, 1500])
@pytest.mark.parametrize("tiles", [1, 3, 1000])
def test_shift_loop_kernel(rolls, tiles):
    x = _full_range(tiles * shift_loop.TILE, rolls + tiles)
    before = launches["tj_shift_loop"]
    _equal((shift_loop.shift_loop(x, rolls),),
           (shift_loop.shift_loop_plain(x, rolls),))
    assert launches["tj_shift_loop"] == before + 1


@pytest.mark.parametrize("tbl_n", [1, 1000, 16384])
@pytest.mark.parametrize("n", [0, 1, 65536, 100_003])
def test_smem_gather_kernel(tbl_n, n):
    tbl = _full_range(tbl_n, 9)
    idx = torch.randint(0, tbl_n, (n,), dtype=torch.int32, device="cuda")
    before = launches["tj_smem_gather"]
    _equal((smem_gather.smem_gather(tbl, idx),),
           (smem_gather.smem_gather_plain(tbl, idx),))
    assert launches["tj_smem_gather"] == before + (n > 0)


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
    before = launches["tj_stream_scale"]
    got = stream.stream_scale(x)
    _equal((got,), (stream.stream_scale_plain(x),))
    assert launches["tj_stream_scale"] == before + (n > 0)
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
    before = launches["tj_slab_count"]
    _equal(slab_count.merge_count_v(b, p, strategy),
           slab_count.merge_count_v_plain(b, p))
    assert launches["tj_slab_count"] == before + (m > 0)


def test_slab_count_lo_above_every_build_key():
    b = torch.ones(1024, dtype=torch.int32, device="cuda")
    p = torch.full((1024,), 2, dtype=torch.int32, device="cuda")
    for strategy in ("fat512", "diag128"):
        lo, cnt = slab_count.merge_count_v(b, p, strategy)
        assert (lo == 1024).all() and not cnt.any()


def _slab_edge_keys(case: str):
    """Sorted (build, probe) keys on the edges the slab search walks."""
    rng = np.random.default_rng(len(case))
    if case == "dup_run":
        # 2,500 copies of one key from build index 1,100 (chunks 1-3 and
        # every slab seam inside them), 1,200 probe copies over tiles 0-1
        b = np.concatenate([rng.integers(100, 5000, 1100), np.full(2500, 5000),
                            rng.integers(5001, 9000, 3000)])
        p = np.concatenate([rng.integers(50, 5000, 600), np.full(1200, 5000),
                            rng.integers(5001, 9500, 5000)])
    elif case == "chunk_start":
        # probe tile 1 starts at key 4096 = b[2048]: its window starts on
        # a chunk boundary
        b = np.arange(0, 16384, 2)
        p = np.concatenate([rng.integers(0, 4096, 1024), [4096],
                            rng.integers(4096, 16384, 3000)])
    elif case == "all_equal":
        b, p = np.full(3000, 42), rng.integers(40, 45, 2500)
    elif case == "small_m":
        b, p = rng.integers(0, 20000, 5000), rng.integers(-10, 20010, 700)
    else:
        ext = np.array([IMIN, IMIN + 1, -1, 0, IMAX - 2, IMAX - 1])
        b, p = rng.choice(ext, 5000), rng.choice(ext, 3000)
    return [torch.from_numpy(np.sort(x).astype(np.int32)).cuda()
            for x in (b, p)]


@pytest.mark.parametrize("strategy", MC_STRATEGIES)
@pytest.mark.parametrize("case", ["dup_run", "chunk_start", "all_equal",
                                  "small_m", "extremes"])
@pytest.mark.parametrize("offset", [0, 1])
def test_slab_count_search_edges(strategy, case, offset):
    """The slab search against the plain version on duplicate runs longer
    than a chunk, a window on a chunk boundary, one build key, fewer probe
    keys than a tile and the i32 extremes; offset 1 puts both columns one
    word past a 16-byte boundary, so the chunks are staged key by key."""
    b, p = (torch.cat([x[:offset], x])[offset:] for x in _slab_edge_keys(case))
    before = launches["tj_slab_count"]
    _equal(slab_count.merge_count_v(b, p, strategy),
           slab_count.merge_count_v_plain(b, p))
    assert launches["tj_slab_count"] == before + 1


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
    before = launches["tj_run_variant"]
    _equal(runs_phases.run_variant(*cols, k, total, capacity, variant),
           runs_phases.run_variant_plain(*cols, k, total, capacity, variant))
    assert launches["tj_run_variant"] == before + 1


RUN_SEAMS = ("empty_runs", "long_runs", "clipped", "before_first")


def _seam_runs(case: str, total_at: str):
    """~2,500 runs of 1-59 slots over several steps, each step's window at
    the 1024-aligned run at or before its first slot (the program's
    layout), random build starts, a full-range source and random source
    bases (so raw goes negative and u + delta passes the slab's end), and
    the seam of ``case``: 40% of the runs empty; runs of 1024, 1500, 9000
    and 20000 slots (a tile, more, more than a step); only 1800 runs
    counted while the window's later offsets still ascend (rel_max clips
    r1); each window starting one run after its step's first slot (slots
    before the window's first offset have no run). The total is 0, a
    mid-tile slot or the capacity."""
    rng = np.random.default_rng(RUN_SEAMS.index(case))
    counts = rng.integers(1, 60, 2500)
    if case == "empty_runs":
        counts[rng.random(counts.size) < 0.4] = 0
    if case == "long_runs":
        counts[[5, 300, 301, 900]] = [1500, 9000, 1024, 20000]
    offs = np.cumsum(counts) - counts
    k = counts.size
    nonzero = 1800 if case == "clipped" else k
    capacity = int(offs[-1] + counts[-1]) + 3000
    steps = -(-capacity // runs_phases.STEP)
    t0s = np.arange(steps) * runs_phases.STEP
    first = np.clip(np.searchsorted(offs, t0s, "right") - 1, 0, nonzero - 1)
    meta_base = (np.minimum(first + 1, nonzero - 1) if case == "before_first"
                 else first // 1024 * 1024)
    npad = -(-k // 1024) * 1024 + runs_phases.META
    cols = [np.full(npad, IMAX), np.zeros(npad, np.int64),
            np.zeros(npad, np.int64)]
    cols[0][:k], cols[1][:k], cols[2][:k] = (offs, rng.integers(0, 8000, k),
                                             rng.permutation(k))
    nsrc = 16384
    src_base = rng.integers(0, nsrc - runs_phases.SRC, steps)
    cols += [rng.integers(IMIN, IMAX, nsrc, endpoint=True), meta_base,
             src_base]
    total = {"zero": 0, "mid_tile": capacity // 2 // 1024 * 1024 + 517,
             "capacity": capacity}[total_at]
    # the seams the data must reach, from the unclipped runs
    t = np.arange(capacity)
    run = np.searchsorted(offs, t, "right") - 1
    tile0 = t // runs_phases.TILE * runs_phases.TILE
    raw = tile0 - offs[run] + cols[1][run] - src_base[t // runs_phases.STEP]
    assert (raw < 0).any() and (t - tile0 + raw % runs_phases.SRC
                                >= runs_phases.SRC).any()
    assert {"empty_runs": lambda: (counts == 0).sum() > 500,
            "long_runs": lambda: counts.max() > runs_phases.STEP,
            "clipped": lambda: offs[nonzero] < capacity,
            "before_first": lambda: (offs[meta_base] > t0s).any()}[case]()
    cols = [torch.from_numpy(c.astype(np.int32)).cuda() for c in cols]
    return cols, nonzero, total, capacity


@pytest.mark.parametrize("variant", runs_phases.VARIANTS)
@pytest.mark.parametrize("case", RUN_SEAMS)
@pytest.mark.parametrize("total_at", ["zero", "mid_tile", "capacity"])
def test_run_variant_seams(variant, case, total_at):
    cols, nonzero, total, capacity = _seam_runs(case, total_at)
    runs_phases.check_bases(cols[0], cols[3], cols[4], cols[5], nonzero,
                            capacity)
    before = launches["tj_run_variant"]
    _equal(runs_phases.run_variant(*cols, nonzero, total, capacity, variant),
           runs_phases.run_variant_plain(*cols, nonzero, total, capacity,
                                         variant))
    assert launches["tj_run_variant"] == before + 1


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
    before = launches["tj_fill_forward"]
    for _ in range(2):      # the status words are zeroed before each launch
        _equal((forward_fill.fill_forward(mark, step),),
               (forward_fill.fill_forward_plain(mark, step),))
    assert launches["tj_fill_forward"] == before + 2


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
    before = launches["tj_expand_fill_v"]
    got = fill_phases.expand_fill_v(*args, step, variant)
    _equal(got, fill_phases.expand_fill_v_plain(*args, step, variant))
    assert launches["tj_expand_fill_v"] == before + (total + extra > 0)
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
    before = launches["tj_op_chain"]
    for sh in (5, -3, IMAX):
        _equal((op_chain.op_chain(x, sh, kind, ops, steps),),
               (op_chain.op_chain_plain(x, sh, kind, ops, steps),))
    assert launches["tj_op_chain"] == before + 3


# shifts on the seams of the kernel's layouts: lane offsets 0, 1 and 31,
# register offsets of one and more, whole turns of 32, 128, 256 and 512,
# negative and the i32 extremes
SEAMS = [0, 1, 31, 32, 33, 127, 128, 255, 256, 511, -1, int(IMIN), int(IMAX)]


@pytest.mark.parametrize("kind", ["roll_sub", "roll_lane"])
@pytest.mark.parametrize("rows", op_chain.ROWS)
@pytest.mark.parametrize("ops", [0, 1, 5, 64])
def test_op_chain_seam_shifts(kind, rows, ops):
    x = _full_range(rows * op_chain.LANES, rows + ops + 7).view(rows, -1)
    before = launches["tj_op_chain"]
    for sh in SEAMS:
        _equal((op_chain.op_chain(x, sh, kind, ops, 2),),
               (op_chain.op_chain_plain(x, sh, kind, ops, 2),))
    assert launches["tj_op_chain"] == before + len(SEAMS)


@pytest.mark.parametrize("rows", [1, 8, 128])
@pytest.mark.parametrize("ops", [0, 1, 33])
@pytest.mark.parametrize("blocks", [1, 1000])
def test_select_chain_kernel(rows, ops, blocks):
    x = _full_range(blocks * rows * select_chain.LANES, rows + ops)
    shifts = _full_range(max(ops, 1), ops)
    shifts[1::2] = torch.arange(1, shifts[1::2].numel() + 1,
                                dtype=torch.int32, device="cuda") * 37
    before = launches["tj_select_chain"]
    _equal((select_chain.select_chain(x, shifts, ops, rows),),
           (select_chain.select_chain_plain(x, shifts, ops, rows),))
    assert launches["tj_select_chain"] == before + 1


def _warp_span(rows: int) -> int:
    """Elements of one warp's range in select_chain's kernel: 128 K, K 4,
    2 or 1 as R is a multiple of 4, of 2 or neither."""
    return 128 * (4 if rows % 4 == 0 else 2 if rows % 2 == 0 else 1)


def _chain_shifts(kind: str, rows: int, ops: int) -> torch.Tensor:
    """``ops`` shifts (at least one): every warp's range edges u_w,
    u_w + 1, u_w + 128K - 1 and u_w + 128K in turn; 0, negatives and the
    i32 ends; or the block's indices in a random order."""
    span, block = _warp_span(rows), rows * select_chain.LANES
    rng = np.random.default_rng(rows * 7 + ops)
    if kind == "edges":
        base = [u + e for u in range(0, block, span)
                for e in (0, 1, span - 1, span)]
    elif kind == "signs":
        base = [0, -1, -37, IMIN, IMAX, 0, -span, IMIN + 1, IMAX - 1]
    else:
        base = rng.permutation(block + 1).tolist()
    shifts = np.resize(np.array(base, np.int64), max(ops, 1))
    return torch.from_numpy(shifts.astype(np.int32)).cuda()


@pytest.mark.parametrize("rows", [1, 2, 8, 128])
@pytest.mark.parametrize("ops", [0, 1, 33, 1024])
@pytest.mark.parametrize("kind", ["edges", "signs", "unsorted"])
def test_select_chain_seams(rows, ops, kind):
    x = _full_range(7 * rows * select_chain.LANES, rows + ops)
    shifts = _chain_shifts(kind, rows, ops)
    before = launches["tj_select_chain"]
    _equal((select_chain.select_chain(x, shifts, ops, rows),),
           (select_chain.select_chain_plain(x, shifts, ops, rows),))
    assert launches["tj_select_chain"] == before + 1


SHIFT_SETS = {"program": [37, 74, 111, 148, 185, 222],
              "negative": [-1, -130, -1024, -1500, IMIN],
              "large": [1024, 1500, IMAX, 1023, 0]}


@pytest.mark.parametrize("shifts", list(SHIFT_SETS))
@pytest.mark.parametrize("rolls", [0, 1, 5])
@pytest.mark.parametrize("steps", [1, 1000])
def test_flat_roll_kernel(shifts, rolls, steps):
    x = _full_range(steps * flat_roll.STEP, steps + rolls)
    ks = torch.tensor(SHIFT_SETS[shifts], dtype=torch.int32, device="cuda")
    before = launches["tj_flat_roll"]
    got = flat_roll.flat_roll(x, ks, rolls)
    _equal((got,), (flat_roll.flat_roll_plain(x, ks, rolls),))
    assert launches["tj_flat_roll"] == before + 1
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


# capability-probe kernel -> (its module, its program)
MOSAIC = {"roll": (mosaic, probe_mosaic),
          "smem_dyn": (mosaic, probe_mosaic),
          "vmem_dyn": (mosaic, probe_mosaic),
          "fori": (mosaic, probe_mosaic),
          "smem_block": (mosaic, probe_mosaic),
          "hbm_to_smem": (mosaic2, probe_mosaic2),
          "dyn_vec_load": (mosaic2, probe_mosaic2),
          "sublane_roll": (mosaic3, probe_mosaic3),
          "row_dma_2d": (mosaic3, probe_mosaic3),
          "flat_rotate": (mosaic3, probe_mosaic3)}


@pytest.mark.parametrize("name,edge", [
    (name, edge) for name, (_, program) in MOSAIC.items()
    for edge in [None] + program.EDGES[name]])
def test_mosaic_kernel(name, edge):
    """Each capability-probe kernel at its program's input (edge None) and,
    on full-range data, at the scalars of its program's EDGES."""
    mod, program = MOSAIC[name]
    args = program.inputs("cuda")[name]
    if edge is not None:
        args = [_full_range(t.numel(), len(edge) + t.numel()).view(t.shape)
                for t in args[:-1]]
        args.append(torch.tensor(edge, dtype=torch.int32, device="cuda"))
    before = launches[f"tj_mosaic_{name}"]
    got = getattr(mod, name)(*args)
    _equal((got,), (getattr(mod, f"{name}_plain")(*args),))
    assert launches[f"tj_mosaic_{name}"] == before + 1


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
    before = launches["tj_fill_forward"]
    r, s = tpujoin_torch.hash_join(bk, pk, result_pad_multiple=pad)
    assert launches["tj_fill_forward"] == before + 1
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


def _range_search_equal(keys, probe):
    """The directory kernel bitwise directory_plain, and the search kernel
    bitwise two torch.searchsorted and search_count_plain."""
    dir_, params = range_search.directory(keys)
    _equal((dir_, params), range_search.directory_plain(keys))
    got = range_search.search_count(keys, probe, dir_, params)
    _equal(got, two_searchsorted(keys, probe))
    _equal(got, range_search.search_count_plain(keys, probe, dir_, params))
    return params


@pytest.mark.parametrize("case", RANGE_CASES)
def test_range_search_kernels(case):
    """Uniform, narrow (shift 0), duplicated, one-key, outlier, negative
    and i32-extreme build keys, n = 1, n = 0 and m = 0; probe keys matched,
    unmatched, below the smallest and above the largest build key."""
    _range_search_equal(*range_case(case, "cuda"))


@pytest.mark.parametrize("offset", range(1, 8))
def test_range_search_on_a_view(offset):
    """Build keys that start 4 to 28 bytes past a 32-byte boundary: the
    kernel's sectors follow the column's own alignment."""
    keys, probe = range_case("uniform", "cuda")
    _range_search_equal(keys[offset:], probe)


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_range_search_at_ref_low_density(dist):
    """1e7 x 1e7 keys: ref_low's draw (keys in [1, 1e9], 32-64 build keys
    a bucket, the largest ~70) and a Zipf(1.0) build side over [1, 1e6],
    whose top key fills one bucket with ~5% of the rows."""
    g = torch.Generator(device="cuda").manual_seed(25)
    rows = 10_000_000
    pk = torch.randint(1, 10**9 + 1, (rows,), generator=g, device="cuda",
                       dtype=torch.int32)
    if dist == "zipf":
        bk = datagen.zipf_keys(torch.Generator().manual_seed(25), rows, 1,
                               10**6).cuda()
        pk = pk % 10**6 + 1
    else:
        bk = torch.randint(1, 10**9 + 1, (rows,), generator=g,
                           device="cuda", dtype=torch.int32)
    params = _range_search_equal(torch.sort(bk).values, pk)
    largest = int(params[2])
    assert largest <= 128 if dist == "uniform" else largest > rows // 25


def test_v1_count_launches_the_directory_and_search_once():
    """hash_join.probe_count on the card: one tj_search_dir and one
    tj_search_count launch, no host sync, (lo, counts) bitwise two
    torch.searchsorted; under the profiler count.search > count.search.dir,
    both with device time."""
    keys, probe = range_case("uniform", "cuda")
    ht = hash_join.build(keys)
    entries = ("tj_search_dir", "tj_search_count")
    before = [launches[e] for e in entries]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hash_join.probe_count(ht, probe)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [launches[e] - b for e, b in zip(entries, before)] == [1, 1]
    _equal(got, two_searchsorted(ht.sorted_keys, probe))
    trace.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        hash_join.probe_count(hash_join.build(keys), probe)
        torch.cuda.synchronize()
    recs = {r["name"]: r for r in trace.records() if r["kind"] == "span"}
    assert recs["count.search.dir"]["parent"] == "count.search"
    assert recs["count.search"]["parent"] == "count"
    assert 0 < recs["count.search.dir"]["device_ms"] <= \
        recs["count.search"]["device_ms"]


@pytest.mark.parametrize("chunk", [None, 3001])
def test_v1_hash_join_on_card_matches_cpu(chunk):
    """v1's hash_join on the card at low selectivity (the count's search,
    then the materialize's search path), in one piece and in probe chunks,
    one directory a chunk: the CPU path's pairs in order, and the
    oracle."""
    rng = np.random.default_rng(26)
    bk = rng.integers(1, 200_001, 100_000).astype(np.int32)
    pk = rng.integers(-10, 200_011, 120_000).astype(np.int32)
    before = launches["tj_search_dir"]
    r, s = tpujoin_torch.hash_join(bk, pk, probe_chunk_rows=chunk)
    chunks = 1 if chunk is None else -(-len(pk) // chunk)
    assert launches["tj_search_dir"] == before + chunks
    cr, cs = tpujoin_torch.hash_join(bk, pk, device="cpu",
                                     probe_chunk_rows=chunk)
    assert len(r) > 0
    np.testing.assert_array_equal(r, cr)
    np.testing.assert_array_equal(s, cs)
    assert oracle.check_join(bk, pk, r, s) == 1


@pytest.mark.parametrize("dom", [5, 3000, 10**9])
def test_match_split_on_card_matches_cpu(dom):
    """semi, anti and left-outer on the card: compact_ids launched on the
    matched flag and its complement, each result bitwise the CPU path's
    (left outer: its pairs as a multiset, its null tail bitwise)."""
    rng = np.random.default_rng(dom)
    bk = rng.integers(1, dom + 1, 20_000).astype(np.int32)
    pk = rng.integers(1, dom + 1, 30_001).astype(np.int32)
    before = launches["tj_compact_ids"]
    semi = tpujoin_torch.semi_join(bk, pk)
    assert launches["tj_compact_ids"] - before == (
        1 if len(semi) in (0, 30_001) else 2)
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
    before = launches["tj_compact_cols"]
    got = multi_join._push(on_card, lambda v: v < keep, "v",
                           multi_join.S_PAD_KEY, ["k"], 4096)
    want = multi_join._push(on_cpu, lambda v: v < keep, "v",
                            multi_join.S_PAD_KEY, ["k"], 4096)
    if keep == 0.0:
        assert got == want == (None, None)
        return
    assert launches["tj_compact_cols"] == before + 1
    _equal(got, tuple(w.cuda() for w in want))


def _dist_keys(n: int, dom: int, seed: int):
    rng = np.random.default_rng(seed)
    rk = rng.integers(1, dom + 1, n).astype(np.int32)
    sk = rng.integers(1, dom + 1, n + 7).astype(np.int32)
    rk[: n // 3] = 3                  # a heavy key for the skew split
    return rk, sk


@pytest.mark.parametrize("program", ["plain", "pipelined", "skew", "rle",
                                     "semi", "anti"])
def test_distributed_program_on_card_matches_cpu(program):
    """Each distributed program on a 4-shard in-process mesh on the card,
    bitwise the same program on a 4-shard CPU mesh (K1 is stable on both,
    so even the pair order agrees), its K1-K4 launched."""
    from tpujoin_torch.parallel import shuffle_join as sj
    from tpujoin_torch.parallel.mesh import make_mesh
    rk, sk = _dist_keys(200_003, 50_000, 1)
    run = {
        "plain": lambda mesh: sj.distributed_hash_join(rk, sk, mesh=mesh),
        "pipelined": lambda mesh: sj.distributed_hash_join(
            rk, sk, mesh=mesh, pipeline_chunks=3),
        "skew": lambda mesh: sj.distributed_hash_join(rk, sk, mesh=mesh,
                                                      skew=True),
        "rle": lambda mesh: sj.distributed_hash_join_rle(rk, sk, mesh=mesh),
        "semi": lambda mesh: (sj.distributed_semi_join(rk, sk, mesh=mesh),),
        "anti": lambda mesh: (sj.distributed_anti_join(rk, sk, mesh=mesh),),
    }[program]
    before = launches["tj_merge_count"]
    got = run(make_mesh(4, device="cuda"))
    want = run(make_mesh(4, device="cpu"))
    assert launches["tj_merge_count"] >= before + 4
    if program == "rle":
        assert got[1] == want[1] == oracle.join_count(rk, sk)
        for g, w in zip(got[0], want[0], strict=True):
            for key in ("probe_ids", "lo", "cnt", "build_ids"):
                np.testing.assert_array_equal(g[key], w[key])
        return
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    if program in ("plain", "pipelined", "skew"):
        assert oracle.check_join(rk, sk, *got) == 1


def test_distributed_join_on_an_nccl_group_of_one():
    """The plain program on a real NCCL process group of world size 1
    (every collective called), bitwise the in-process CPU mesh's."""
    import socket

    import torch.distributed as dist
    from tpujoin_torch.parallel import multihost
    from tpujoin_torch.parallel.mesh import make_mesh
    from tpujoin_torch.parallel.shuffle_join import distributed_hash_join
    rk, sk = _dist_keys(100_000, 30_000, 2)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=1, process_id=0)
    try:
        mesh = multihost.make_global_mesh()
        assert dist.get_backend() == "nccl" and mesh.group is not None
        assert mesh.size == 1 and mesh.device.type == "cuda"
        got = distributed_hash_join(rk, sk, mesh=mesh, pipeline_chunks=2)
    finally:
        dist.destroy_process_group()
    want = distributed_hash_join(rk, sk, mesh=make_mesh(1, device="cpu"),
                                 pipeline_chunks=2)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


# the program's spans (tpujoin_torch/trace.py) on the card: case ->
# (rows a side, key domain); expand.dup16 has ~16 matches a row
TRACED_PATHS = {"expand": (1 << 20, 10**9), "expand.dup16": (1 << 16, 4096),
                "groups": (1 << 16, 256), "fill": (1 << 16, 256)}


def _traced_join(rows: int, dom: int, path: str, seed: int = 0):
    """build, probe_count and the materialize of ``path`` (a case of
    TRACED_PATHS: the planner's path up to the first dot) on the card, as
    the benchmark runs them (the count's totals read between), groups
    called directly since no planner path reaches it. Returns the number
    of host syncs torch flags in the program's calls (sync debug mode,
    every warning caught)."""
    import warnings
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bk, pk = (torch.randint(1, dom + 1, (rows,), generator=gen,
                            dtype=torch.int32, device="cuda")
              for _ in range(2))
    torch.cuda.synchronize()

    def flagged(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, sum("synchroniz" in str(w.message) for w in caught)

    from tpujoin_torch.ops import merge_join as mj

    def count():
        ht = hash_join.build(bk)
        return ht, *mj.probe_count(ht, pk)

    (ht, state, total, nonzero), n_count = flagged(count)
    total, nonzero = int(total), int(nonzero)
    caps = (round_up(nonzero, 1024), round_up(total, 1 << 20))
    if path == "groups":
        with trace.span("materialize.groups", state.counts, ht.trace_id):
            _, n_mat = flagged(lambda: mj.probe_materialize_groups(
                ht, state, *caps, total=total, nonzero=nonzero))
    else:
        (name, _, _), n_mat = flagged(lambda: mj.plan_materialize(
            ht, state, *caps, total=total, nonzero=nonzero))
        assert name == path.split(".")[0]
    torch.cuda.synchronize()
    return n_count + n_mat


@pytest.mark.parametrize("path", sorted(TRACED_PATHS))
def test_sync_spans_are_the_syncs_torch_flags(path):
    """Every host sync a join makes on each materialize path is a sync.*
    record, and only those: their count equals the syncs torch's sync
    debug mode flags in the program's calls."""
    _traced_join(*TRACED_PATHS[path], path)          # warm-up, untraced
    trace.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        flagged = _traced_join(*TRACED_PATHS[path], path)
    syncs = [r["name"] for r in trace.records() if r["kind"] == "sync"]
    assert flagged > 0 and len(syncs) == flagged, syncs


def test_device_spans_nest_and_the_phases_sum_to_their_span():
    """One ref_low-sized join (100M x 100M, keys to 1e9) under the
    profiler: each child's device span lies inside its parent's, and the
    children of build and of count sum to within 5% of it. The spans
    draw no row on the device's timeline, whose rows are device work."""
    rows, dom = 100_000_000, 10**9
    _traced_join(rows, dom, "expand", seed=1)
    trace.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _traced_join(rows, dom, "expand", seed=1)
    raw = [r for r in trace._records if r[5] is not None]
    by_name = {r[0]: r for r in raw}
    assert len(by_name) == len(raw)           # one join, each name once
    for name, parent, *_, start, end in raw:
        if parent not in by_name:   # a root, or a host-clock parent
            continue
        p_start, p_end = by_name[parent][5:]
        assert p_start.elapsed_time(start) >= 0, name
        assert end.elapsed_time(p_end) >= 0, name
    # the expand path's timed phases, one after another on the stream
    phases = [by_name[n][5:] for n in ("compact", "offsets", "pairs")]
    for (_, end), (start, _) in zip(phases, phases[1:]):
        assert end.elapsed_time(start) >= 0
    ms = {r["name"]: r["device_ms"] for r in trace.records()
          if r["device_ms"] is not None}
    for parent in ("build", "count"):
        parts = sum(v for k, v in ms.items() if k.startswith(parent + "."))
        assert abs(parts - ms[parent]) <= 0.05 * ms[parent], (parent, ms)
    assert trace.records() == trace.records()      # resolved once, kept
    assert not [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith(trace.PREFIX)]


def test_order_key_join_launches_k3_and_k4_once_and_times_them():
    """A join on joinbench's TPC-H order keys (2^20 orders by 4.2M
    lineitems, every lineitem matched once) on the card: compact3's count
    and scatter and K7b launch once a join, on the expand path, and K4
    never; the pairs match the reference; under the profiler the expand
    path's compact, offsets and pairs and the v1 count's count.search carry
    device time, and without one nothing records."""
    from joinbench import compare, harness, reference
    from tpujoin_torch.ops import merge_join as mj
    keys = harness.load_module(harness.HERE / "keys" / "tpch_orderkey.py")
    cfg = {"build_rows": 1 << 20, "probe_rows": 4_200_000}
    gen = torch.Generator(device="cuda").manual_seed(22)
    bk, pk = (keys.make(gen, cfg[side], cfg)
              for side in ("build_rows", "probe_rows"))

    def join():
        ht = hash_join.build(bk)
        state, total, nonzero = mj.probe_count(ht, pk)
        total, nonzero = int(total), int(nonzero)
        out = mj.plan_materialize(ht, state, round_up(nonzero, 1 << 20),
                                  round_up(total, 1 << 20), total=total,
                                  nonzero=nonzero)
        torch.cuda.synchronize()
        return total, nonzero, out

    entries = ("tj_compact_count", "tj_compact_cols", "tj_expand_runs",
               "tj_expand")
    before = [launches[e] for e in entries]
    total, nonzero, (path, (r_ids, s_ids, _), _) = join()
    assert [launches[e] - b for e, b in zip(entries, before)] == [1, 1, 1, 0]
    assert path == "expand" and total == nonzero == cfg["probe_rows"]
    ref = reference.factorize(bk, pk)
    assert compare.pair_checks(r_ids, s_ids, total, ref) == {"pairs_off": 0}
    del r_ids, s_ids, ref

    trace.clear()
    join()
    hash_join.probe_count(hash_join.build(bk), pk)
    assert [r for r in trace.records() if r["kind"] != "setup"] == []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        join()
        hash_join.probe_count(hash_join.build(bk), pk)
        torch.cuda.synchronize()
    ms = {}
    for r in trace.records():
        if r["device_ms"] is not None:
            ms.setdefault(r["name"], []).append(r["device_ms"])
    for name in ("compact", "offsets", "pairs", "count.search"):
        assert len(ms[name]) == 1 and ms[name][0] > 0, (name, ms)
    assert sum(ms["count"]) >= ms["count.search"][0]


@pytest.mark.parametrize("caps", ["exact", "tail"])
@pytest.mark.parametrize("probe_base", [0, 1000])
@pytest.mark.parametrize("shape", ["one_slot", "dup"])
def test_expand_path_on_the_card_matches_the_previous_columns(shape,
                                                               probe_base,
                                                               caps):
    """probe_materialize on the card (K3, the cumsum, K7b: one
    tj_expand_runs launch, no tj_expand) against K4 and its glue on the
    CPU, bitwise, with the columns and ``fits``."""
    from tpujoin_torch.ops import merge_join as mj
    (ht, state), (ht_cpu, state_cpu) = (expand_case(shape, 200_000, dev)
                                        for dev in ("cuda", "cpu"))
    cnt = state_cpu.counts
    total, nonzero = int(cnt.sum()), int((cnt > 0).sum())
    k_cap, cap = ((nonzero, total) if caps == "exact"
                  else (nonzero + 37, total + 1000))
    entries = ("tj_expand_runs", "tj_expand")
    before = [launches[e] for e in entries]
    r, s, tot, fits = mj.probe_materialize(ht, state, k_cap, cap,
                                           probe_base, total=total,
                                           nonzero=nonzero)
    torch.cuda.synchronize()
    assert [launches[e] - b for e, b in zip(entries, before)] == [1, 0]
    want_r, want_s, want_fits = previous_expand_path(
        ht_cpu, state_cpu, k_cap, cap, probe_base, total, nonzero)
    assert r.is_cuda and r.dtype == s.dtype == torch.int32
    assert torch.equal(r.cpu(), want_r) and torch.equal(s.cpu(), want_s)
    assert bool(fits) == want_fits and int(tot) == total
