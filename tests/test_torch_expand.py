"""K4, tpujoin_torch's expand, against the JAX package's Pallas expand in
interpret mode: bpos and sid_out bitwise on every slot below the total
(slots past it carry no pair in either). The cases are those of
tests/test_expand.py, at capacity == total and capacity > total.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.kernels.expand import expand as jax_expand
from tpujoin_torch.kernels import expand as ex


def _make_case(rng, k, max_count, lo_dom):
    counts = rng.integers(1, max_count + 1, k).astype(np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    lo = np.sort(rng.integers(0, lo_dom, k)).astype(np.int32)
    sid = rng.permutation(k).astype(np.int32)
    return counts, offsets, lo, sid, int(counts.sum())


def _ref(counts, offsets, lo, sid, total):
    rows = np.repeat(np.arange(len(counts)), counts)
    j = np.arange(total) - offsets[rows]
    return (lo[rows] + j).astype(np.int32), sid[rows]


CASES = [(1000, 1, 0),     # all singleton matches
         (300, 20, 1),     # mixed run lengths
         (1, 5000, 2),     # one giant run (skew)
         (2000, 3, 3)]


@pytest.mark.parametrize("extra", [0, 333], ids=["exact", "padded"])
@pytest.mark.parametrize("k,max_count,seed", CASES)
def test_matches_jax_expand(k, max_count, seed, extra):
    counts, offsets, lo, sid, total = _make_case(
        np.random.default_rng(seed), k, max_count, 10**6)
    cap = total + extra
    jb, js = jax_expand(jnp.asarray(offsets), jnp.asarray(lo),
                        jnp.asarray(sid), capacity=cap, interpret=True)
    bpos, sout = ex.expand(torch.from_numpy(offsets), torch.from_numpy(lo),
                           torch.from_numpy(sid), cap)
    assert bpos.shape == sout.shape == (cap,)
    np.testing.assert_array_equal(bpos.numpy()[:total], np.asarray(jb)[:total])
    np.testing.assert_array_equal(sout.numpy()[:total], np.asarray(js)[:total])
    exp_b, exp_s = _ref(counts, offsets, lo, sid, total)
    np.testing.assert_array_equal(bpos.numpy()[:total], exp_b)
    np.testing.assert_array_equal(sout.numpy()[:total], exp_s)


def _plain_ref(offsets, lo, sid, capacity):
    """numpy's expand_plain on every slot up to capacity: the row
    upper_bound - 1, clamped to [0, K - 1], and i32 wrapping arithmetic."""
    t = np.arange(capacity, dtype=np.int64)
    r = np.clip(np.searchsorted(offsets, t, "right") - 1, 0, len(offsets) - 1)
    bpos = (lo[r].astype(np.int64) + t - offsets[r]).astype(np.uint32)
    return bpos.astype(np.int32), sid[r]


# (k, max_count, seed, zero-tail rows, capacity - total): the card
# kernel's hazards at small sizes; its tiles hold 2048 slots
TAILS = [(300, 20, 4, 2 * 2048 + 5, 777),   # a zero tail over two tiles
         (1, 5000, 5, 3000, 2048 // 2 + 3),  # one giant run, a long tail
         (2000, 3, 6, 1, 0),                 # capacity == total
         (700, 9, 7, 5000, -1000)]           # capacity below the total


@pytest.mark.parametrize("k,max_count,seed,pad,extra", TAILS)
def test_zero_tail_and_ragged_capacity(k, max_count, seed, pad, extra):
    """compact3's zero tail (offset == total, lo == sid == 0) longer than a
    tile, and capacities that end mid-tile: against the JAX kernel below
    the total, and against numpy on every slot up to capacity."""
    counts, offsets, lo, sid, total = _make_case(
        np.random.default_rng(seed), k, max_count, 10**6)
    offsets = np.concatenate([offsets, np.full(pad, total, np.int32)])
    lo = np.concatenate([lo, np.zeros(pad, np.int32)])
    sid = np.concatenate([sid, np.zeros(pad, np.int32)])
    cap = total + extra
    bpos, sout = ex.expand(torch.from_numpy(offsets), torch.from_numpy(lo),
                           torch.from_numpy(sid), cap)
    want_b, want_s = _plain_ref(offsets, lo, sid, cap)
    np.testing.assert_array_equal(bpos.numpy(), want_b)
    np.testing.assert_array_equal(sout.numpy(), want_s)
    jb, js = jax_expand(jnp.asarray(offsets), jnp.asarray(lo),
                        jnp.asarray(sid), capacity=cap, interpret=True)
    below = min(total, cap)
    np.testing.assert_array_equal(bpos.numpy()[:below], np.asarray(jb)[:below])
    np.testing.assert_array_equal(sout.numpy()[:below], np.asarray(js)[:below])


def test_rejects_empty_rows_and_wide_capacity():
    z = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError):
        ex.expand(z, z, z, 4)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ex.expand(one, one, one, 2**31)
