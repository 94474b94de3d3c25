"""K5 expand_fill and K7 expand_groups of tpujoin_torch against the JAX
package's Pallas kernels in interpret mode, bitwise over the whole
capacity (both put -1 in both columns from the total on).

The cases are those of tests/test_expand_fill.py and
tests/test_expand_groups.py where the JAX kernel reports ``fits``, laid
out at one fixed width (run, group and source rows padded as the JAX
planner pads them) so that the interpret-mode compiles are shared; the JAX
kernels run with the small envelopes their own tests use.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.kernels.expand_fill import NBMAX
from tpujoin.kernels.expand_fill import expand_fill as jax_expand_fill
from tpujoin.kernels.expand_groups import expand_groups as jax_expand_groups
from tpujoin_torch.kernels import expand_fill as ef
from tpujoin_torch.kernels import expand_groups as eg
from tpujoin_torch.trace import launches

K, G, N, CAP = 1024, 256, 32768, 32768   # rows of runs, groups, src; slots
SRC_SLAB = 16384
FILL_PROFILE = {"step": 4096, "gw": 6}            # tests/test_expand_fill.py
GROUPS_PROFILE = {"batch": 4, "w": 16, "gw": 8}   # tests/test_expand_groups.py
INT32_MAX = np.iinfo(np.int32).max


def layout(counts, lo, sid, src):
    """Per-run counts/lo/sid (runs with equal lo form one group) as the
    kernels' inputs at the fixed widths: (roff, rsid, goff, glo, gnb, src)
    as numpy int32, and (nruns, ngroups, total)."""
    counts = np.asarray(counts, np.int32)
    lo = np.asarray(lo, np.int32)
    k = len(counts)
    offs = (np.cumsum(counts) - counts).astype(np.int32)
    total = int(counts.sum())
    head = np.ones(k, bool)
    head[1:] = lo[1:] != lo[:-1]
    ng = int(head.sum())

    def padded(vals, width, fill):
        out = np.full(width, fill, np.int32)
        out[:len(vals)] = vals
        return out

    cols = (padded(offs, K, total), padded(sid, K, 0),
            padded(offs[head], G, INT32_MAX), padded(lo[head], G, 0),
            padded(counts[head], G, 1), padded(src, N, 0))
    return cols, (k, ng, total)


def _randomized(seed):
    """tests/test_expand_fill.py's randomized groups, at most 4 groups of
    at most 20 runs so the result fits CAP."""
    rng = np.random.default_rng(seed)
    g = int(rng.integers(1, 5))
    gnb = rng.integers(96, 200, size=g).astype(np.int32)
    gnp = rng.integers(15, 21, size=g).astype(np.int32)
    gaps = rng.integers(0, 5, size=g)
    glo = (np.cumsum(gnb + gaps) - (gnb + gaps)).astype(np.int32)
    src = rng.integers(0, 1 << 30, size=int(glo[-1] + gnb[-1] + 8),
                       dtype=np.int32)
    return (np.repeat(gnb, gnp), np.repeat(glo, gnp),
            rng.permutation(int(gnp.sum())), src)


CASES = {
    "single_run": ([5], [2], [7], np.arange(100) * 3),
    "one_group_many_runs": ([4] * 6, [10] * 6, [5, 9, 2, 7, 1, 3],
                            np.arange(64) * 11),
    "adjacent_groups": ([3, 3, 4, 1, 1], [0, 0, 3, 7, 7], [9, 1, 4, 2, 8],
                        np.arange(64) + 100),
    "period_crossing_tiles": ([700] * 9, [100] * 9, list(range(9)),
                              np.arange(4000)),
    "group_spanning_steps": ([1500] * 5, [1] * 5, list(range(5)),
                             np.arange(4000)),
    "giant_group_spanning_steps": ([3500] * 6, [1] * 6, list(range(6)),
                                   np.arange(8000)),
    "long_run_small_groups": ([5000, 5000, 17], [0, 0, 6000], [3, 1, 2],
                              np.arange(8000)),
    "max_period": ([NBMAX] * 3, [7] * 3, [2, 0, 1], np.arange(NBMAX + 512)),
    "dense_runs": ([1] * 600, [3] * 600,
                   np.random.default_rng(0).permutation(600), np.arange(16)),
    # run offsets on 512-slot steps, many on 1024- and 4096-slot tile edges
    "tile_edge_runs": ([1024] * 4 + [2048] * 4 + [512] * 8 + [3] * 5,
                       [0] * 4 + [1100] * 4 + [3200] * 8 + [5000] * 5,
                       np.random.default_rng(1).permutation(21),
                       np.arange(6000)),
    # a tile's run window at its TILE + 1 bound, in one group of period 1
    "one_slot_runs_one_group": ([1] * 1020, [5] * 1020,
                                np.random.default_rng(2).permutation(1020),
                                np.arange(64)),
    **{f"randomized_{s}": _randomized(s) for s in range(4)},
}
# where each JAX kernel fits: expand_fill holds periods up to NBMAX,
# expand_groups at most w - 2 runs per 1024-slot tile
FILL_CASES = [c for c in CASES if c not in ("giant_group_spanning_steps",
                                            "long_run_small_groups")]
GROUPS_CASES = [c for c in CASES
                if c not in ("dense_runs", "one_slot_runs_one_group")]


def _torch(cols):
    return [torch.from_numpy(c) for c in cols]


def _jax(cols, sizes):
    return ([jnp.asarray(c) for c in cols]
            + [jnp.int32(v) for v in sizes])


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_expand_fill_matches_jax(case):
    cols, sizes = layout(*CASES[case])
    jr, js, fits = jax_expand_fill(*_jax(cols, sizes), CAP,
                                   src_slab=SRC_SLAB, **FILL_PROFILE)
    assert bool(fits)
    r, s = ef.expand_fill(*_torch(cols), *sizes, CAP)
    assert r.dtype == s.dtype == torch.int32 and r.shape == (CAP,)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("case", sorted(GROUPS_CASES))
def test_expand_groups_matches_jax(case):
    cols, sizes = layout(*CASES[case])
    jr, js, fits = jax_expand_groups(*_jax(cols, sizes), CAP,
                                     src_slab=SRC_SLAB, **GROUPS_PROFILE)
    assert bool(fits)
    r, s = eg.expand_groups(*_torch(cols), *sizes, CAP)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_expand_fill_ragged_capacity_and_empty_match_jax():
    """A capacity that is no multiple of anything, cutting the result
    (tests/test_expand_fill.py::test_capacity_padding_marks_invalid), and
    an empty result."""
    for case in (([3, 3], [0, 0], [1, 2], np.arange(16)),
                 ([3, 3, 4, 2], [0, 0, 5, 9], [1, 2, 0, 3], np.arange(16))):
        cols, sizes = layout(*case)
        jr, js, fits = jax_expand_fill(*_jax(cols, sizes), 10,
                                       src_slab=SRC_SLAB, **FILL_PROFILE)
        assert bool(fits)
        r, s = ef.expand_fill(*_torch(cols), *sizes, 10)
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    cols, _ = layout(*CASES["single_run"])
    jr, js, _ = jax_expand_fill(*_jax(cols, (0, 0, 0)), CAP,
                                src_slab=SRC_SLAB, **FILL_PROFILE)
    r, s = ef.expand_fill(*_torch(cols), 0, 0, 0, CAP)
    assert (r.numpy() == -1).all() and (s.numpy() == -1).all()
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_plain_versions_work_in_chunks(monkeypatch):
    """The plain version's answer does not depend on its chunk size."""
    cols, sizes = layout(*CASES["randomized_1"])
    whole = ef.expand_fill(*_torch(cols), *sizes, CAP)
    monkeypatch.setattr(ef, "PLAIN_CHUNK", 1000)
    for got, want in zip(ef.expand_fill(*_torch(cols), *sizes, CAP), whole):
        assert torch.equal(got, want)


def test_cpu_tensors_take_the_plain_version_and_bad_sizes_raise():
    cols, (k, ng, total) = layout(*CASES["adjacent_groups"])
    before = launches["tj_expand_fill"]   # K5's entry, both wrappers'
    for fn, plain in ((ef.expand_fill, ef.expand_fill_plain),
                      (eg.expand_groups, eg.expand_groups_plain)):
        for got, want in zip(fn(*_torch(cols), k, ng, total, 64),
                             plain(*_torch(cols), k, ng, total, 64)):
            assert torch.equal(got, want)
        with pytest.raises(ValueError):
            fn(*_torch(cols), K + 1, ng, total, 64)    # more runs than rows
        with pytest.raises(ValueError):
            fn(*_torch(cols), k, ng, 2**31, 64)        # not an i32 total
    assert launches["tj_expand_fill"] == before
