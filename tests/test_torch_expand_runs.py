"""K7 expand_runs of tpujoin_torch against the JAX package's Pallas kernel
in interpret mode, bitwise over the whole capacity (both put -1 in both
columns from the total on).

The cases are those of tests/test_expand_runs.py (where the JAX kernel
reports ``fits``), laid out at one fixed width with a tail of pad runs as
the compaction leaves it (offset == total), so that the interpret-mode
compiles are shared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.kernels.expand_runs import expand_runs as jax_expand_runs
from tpujoin_torch.kernels import expand_runs as er
from tpujoin_torch.trace import launches

K, N, CAP = 1024, 32768, 32768   # rows of runs and of src; slots
WIDE_K = 4096                    # rows of runs of the one-slot case
SRC_SLAB = 16384


def layout(counts, lo, sid, src, width=K):
    """Per-run counts/lo/sid as the JAX kernel's inputs at the fixed
    widths (``width`` rows of runs): (offsets, lo, counts, sid, src) as
    numpy int32, and (nonzero, total). The port's kernel takes the same
    without the counts."""
    counts = np.asarray(counts, np.int32)
    k = len(counts)
    total = int(counts.sum())

    def padded(vals, width, fill=0):
        out = np.full(width, fill, np.int32)
        out[:len(vals)] = vals
        return out

    offs = (np.cumsum(counts) - counts).astype(np.int32)
    cols = (padded(offs, width, total), padded(lo, width),
            padded(counts, width), padded(sid, width), padded(src, N))
    return cols, (k, total)


def _randomized(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 200))
    counts = rng.integers(1, 50, size=k).astype(np.int32)
    gaps = rng.integers(0, 5, size=k)
    lo = (np.cumsum(counts + gaps) - (counts + gaps)).astype(np.int32)
    src = rng.integers(0, 1 << 30, size=int(lo[-1] + counts[-1] + 8),
                       dtype=np.int32)
    return counts, lo, rng.permutation(k), src


def _runs_of(counts, seed):
    """Runs of ``counts`` over one source column, each run's slice a few
    ids past the last one's start (lo non-decreasing, as the count leaves
    it), probe ids a permutation."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    lo = np.cumsum(rng.integers(0, 4, len(counts))).astype(np.int32)
    src = rng.integers(0, 1 << 30, int((lo + counts).max()) + 8,
                       dtype=np.int32)
    return counts, lo, rng.permutation(len(counts)), src


CASES = {
    "single_run": ([5], [2], [7], np.arange(100) * 3),
    "adjacent_runs": ([3, 4, 1], [0, 3, 7], [9, 1, 4], np.arange(64) + 100),
    "duplicate_probe_keys": ([4, 4, 4, 2], [10, 10, 10, 20], [5, 6, 7, 8],
                             np.arange(64) * 11),
    "run_spanning_many_tiles": ([20000], [1], [3], np.arange(30000)),
    **{f"randomized_{s}": _randomized(s) for s in range(3)},
    # runs longer than the card's 2048-slot tile, between short ones
    "runs_longer_than_a_tile": _runs_of([2049, 3, 4097, 1, 2500, 6000, 7],
                                        4),
}


def _run_both(cols, sizes, capacity):
    jr, js, fits = jax_expand_runs(*(jnp.asarray(c) for c in cols),
                                   *(jnp.int32(v) for v in sizes), capacity,
                                   src_slab=SRC_SLAB)
    assert bool(fits)
    offs, lo, _, sid, src = (torch.from_numpy(c) for c in cols)
    r, s = er.expand_runs(offs, lo, sid, src, *sizes, capacity)
    assert r.dtype == s.dtype == torch.int32 and r.shape == (capacity,)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    return r, s


@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_runs_matches_jax(case):
    _run_both(*layout(*CASES[case]), CAP)


def test_three_thousand_one_slot_runs_match_jax():
    """3000 one-slot runs (a card tile meets TILE + 1 of them), in three
    batches of 1000 between runs of 9000 slots, so that no grid step of
    the JAX kernel holds more runs than its metadata slab."""
    counts = [1] * 1000 + [9000] + [1] * 1000 + [9000] + [1] * 1000
    cols, sizes = layout(*_runs_of(counts, 5), width=WIDE_K)
    r, s = _run_both(cols, sizes, CAP)
    assert sizes == (3002, 21000) and (s[:1000] >= 0).all()


def test_expand_runs_ragged_capacity_and_empty_match_jax():
    """tests/test_expand_runs.py's capacity padding (capacity 10 past a
    total of 3) and empty result."""
    cols, sizes = layout([3], [0], [1], np.arange(16))
    r, s = _run_both(cols, sizes, 10)
    assert r.tolist() == [0, 1, 2] + [-1] * 7
    assert s.tolist() == [1, 1, 1] + [-1] * 7
    r, s = _run_both(cols, (0, 0), 10)
    assert (r == -1).all() and (s == -1).all()


def test_source_past_its_end_reads_minus_one():
    """A run reaching past the source ids reads -1 there, as the JAX
    kernel's -1 padding of the source does (the kernel never reads out of
    bounds)."""
    offs, lo, sid, src = (torch.tensor(v, dtype=torch.int32) for v in
                          ([0], [6], [2], [10, 11, 12, 13, 14, 15, 16, 17]))
    r, s = er.expand_runs(offs, lo, sid, src, 1, 4, 5)
    assert r.tolist() == [16, 17, -1, -1, -1]
    assert s.tolist() == [2, 2, 2, 2, -1]


def test_cpu_tensors_take_the_plain_version_and_bad_sizes_raise():
    cols, (k, total) = layout(*CASES["adjacent_runs"])
    cols = [torch.from_numpy(c) for i, c in enumerate(cols) if i != 2]
    before = launches["tj_expand_runs"]
    for got, want in zip(er.expand_runs(*cols, k, total, 64),
                         er.expand_runs_plain(*cols, k, total, 64)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        er.expand_runs(*cols, K + 1, total, 64)
    with pytest.raises(ValueError):
        er.expand_runs(*cols, k, total, -1)
    assert launches["tj_expand_runs"] == before
