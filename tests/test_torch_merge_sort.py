"""K1, the (key, id) sort of tpujoin_torch, against the JAX package's Pallas
merge sort (interpret mode) and against numpy: sort_pairs, and the chain of
plain versions its kernels run (one digit histogram, four digit passes);
sort_rows and the iota pass against sort_pairs of the row numbers.

Both sorts may order ids within a run of equal keys differently (the JAX
one is unstable), so ids are compared as a multiset per equal-key run:
the (key, id) pairs sorted lexicographically must be equal. The exact
tolerance holds everywhere: all outputs are integers.

The JAX calls share one width (N) and tile (T) so the module compiles its
interpret-mode kernels once.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.kernels import merge_sort as jax_ms
from tpujoin_torch.kernels import merge_sort as ms


N = 1 << 13
T = 1 << 10
IMAX = np.iinfo(np.int32).max
IMIN = np.iinfo(np.int32).min


def _keys(dist: str, n: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        return rng.integers(1, 10**9, n).astype(np.int32)
    if dist == "dup8":
        return rng.integers(0, 8, n).astype(np.int32)
    if dist == "all_equal":
        return np.full(n, 42, np.int32)
    if dist == "reversed":
        return np.arange(n, 0, -1).astype(np.int32)
    if dist == "extremes":
        return rng.choice(np.array([IMIN, -1, 0, 1, IMAX - 1, IMAX],
                                   np.int32), n)
    raise ValueError(dist)


def _pairs(keys, ids) -> np.ndarray:
    """(key, id) pairs in lexicographic order: the per-run id multisets."""
    order = np.lexsort((ids, keys))
    return np.stack([keys[order], ids[order]])


def _port_sort(keys: np.ndarray):
    ids = np.arange(keys.shape[0], dtype=np.int32)
    k, i = ms.sort_pairs(torch.from_numpy(keys), torch.from_numpy(ids))
    return k.numpy(), i.numpy()


def _chain(keys: np.ndarray, ids: np.ndarray):
    """One histogram and four digit passes, each the plain version."""
    k, i = torch.from_numpy(keys), torch.from_numpy(ids)
    hist = ms.sort_histogram_plain(k)
    assert tuple(hist.shape) == (len(ms.SHIFTS), ms.RADIX)
    for shift in ms.SHIFTS:
        k, i = ms.sort_pass_plain(k, i, shift)
    return k.numpy(), i.numpy()


@functools.lru_cache(maxsize=None)
def _jax_sort(dist: str, n: int):
    keys = _keys(dist, n)
    ids = np.arange(n, dtype=np.int32)
    jk, ji = jax_ms.sort_pairs(jnp.asarray(keys), jnp.asarray(ids),
                               run_len0=T, t_out=T, interpret=True)
    return np.asarray(jk), np.asarray(ji)


@pytest.mark.parametrize("dist,n", [
    ("uniform", N), ("dup8", N), ("all_equal", N), ("reversed", N),
    ("uniform", N - 77),   # ragged: the JAX sort pads to N
])
def test_matches_jax_sort_pairs(dist, n):
    keys = _keys(dist, n)
    ids = np.arange(n, dtype=np.int32)
    jk, ji = _jax_sort(dist, n)
    k, i = _port_sort(keys)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(keys[i], k)
    np.testing.assert_array_equal(np.sort(i), ids)
    np.testing.assert_array_equal(_pairs(k, i), _pairs(jk, ji))


@pytest.mark.parametrize("n", [1, ms.TILE - 1, ms.TILE + 1, 5 * ms.TILE + 3])
def test_every_i32_key_keeps_its_id(n):
    """INT32_MAX - 1 and INT32_MAX sort like any key and keep their ids —
    the JAX sort pads with (INT32_MAX - 1, id 0), so a real key of
    INT32_MAX - 1 can lose its id at the crop there."""
    keys = _keys("extremes", n, seed=n)
    k, i = _port_sort(keys)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(i, order.astype(np.int32))


@pytest.mark.parametrize("dist,n", [
    ("uniform", N), ("dup8", N), ("all_equal", N), ("reversed", N),
    ("uniform", N - 77),   # ragged: the JAX sort pads to N
])
def test_digit_passes_match_jax_sort_pairs(dist, n):
    keys = _keys(dist, n)
    jk, ji = _jax_sort(dist, n)
    k, i = _chain(keys, np.arange(n, dtype=np.int32))
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(_pairs(k, i), _pairs(jk, ji))


@pytest.mark.parametrize("n", [1, ms.TILE - 1, ms.TILE + 1, 3 * ms.TILE + 5])
def test_digit_passes_are_a_stable_sort_of_the_extremes(n):
    keys = _keys("extremes", n, seed=n + 1)
    k, i = _chain(keys, np.arange(n, dtype=np.int32))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(i, order.astype(np.int32))


@pytest.mark.parametrize("dist", ["uniform", "dup8", "all_equal",
                                  "reversed", "extremes"])
def test_histogram_counts_each_digit(dist):
    keys = _keys(dist, N - 77)
    biased = keys.view(np.uint32) ^ np.uint32(0x80000000)
    want = np.stack([np.bincount((biased >> s) & 255, minlength=256)
                     for s in ms.SHIFTS]).astype(np.int32)
    got = ms.sort_histogram_plain(torch.from_numpy(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_one_pass_is_stable(shift):
    """dup8 keys moved onto the digit: eight digit values with ~1,400
    pairs each, whose ids must rise within a digit."""
    n = 3 * ms.TILE + 5
    keys = (_keys("dup8", n, seed=3) << shift).astype(np.int32)
    ids = np.arange(n, dtype=np.int32)
    k, i = ms.sort_pass_plain(torch.from_numpy(keys), torch.from_numpy(ids),
                              shift)
    k, i = k.numpy(), i.numpy()
    digit = (k.view(np.uint32) ^ np.uint32(0x80000000)) >> shift & 255
    assert (np.diff(digit.astype(np.int64)) >= 0).all()
    same = np.diff(digit.astype(np.int64)) == 0
    assert (np.diff(i)[same] > 0).all()
    np.testing.assert_array_equal(keys[i], k)


@pytest.mark.parametrize("dist,n", [
    ("uniform", N), ("dup8", N), ("all_equal", N), ("reversed", N),
    ("extremes", N), ("uniform", N - 77), ("extremes", ms.TILE + 1),
    ("uniform", 1), ("uniform", 0),
])
def test_sort_rows_is_sort_pairs_of_the_row_numbers(dist, n):
    keys = torch.from_numpy(_keys(dist, n))
    want = ms.sort_pairs(keys, torch.arange(n, dtype=torch.int32))
    for got in (ms.sort_rows(keys), ms.sort_rows_plain(keys)):
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)


@pytest.mark.parametrize("dist", ["dup8", "extremes"])
def test_iota_pass_is_the_shift0_pass_of_the_row_numbers(dist):
    keys = torch.from_numpy(_keys(dist, 3 * ms.TILE + 5, seed=4))
    ids = torch.arange(keys.shape[0], dtype=torch.int32)
    want = ms.sort_pass_plain(keys, ids, 0)
    for got in (ms.sort_pass_iota(keys, ms.sort_histogram(keys)),
                ms.sort_pass_iota_plain(keys)):
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w)
    with pytest.raises(ValueError):
        ms.sort_pass_iota(keys, ms.sort_histogram(keys)[:2])


def test_kernels_leave_inputs():
    keys = torch.from_numpy(_keys("dup8", 3 * ms.TILE + 5, seed=1))
    ids = torch.arange(keys.shape[0], dtype=torch.int32)
    before = keys.clone(), ids.clone()
    hist = ms.sort_histogram(keys)
    for shift in ms.SHIFTS:
        ms.sort_pass(keys, ids, shift, hist)
    k, i = ms.sort_pairs(keys, ids)
    assert torch.equal(keys, before[0]) and torch.equal(ids, before[1])
    assert k.data_ptr() != keys.data_ptr() and i.data_ptr() != ids.data_ptr()


@pytest.mark.parametrize("shift", [-8, 4, 32, 7])
def test_pass_refuses_other_shifts(shift):
    keys = torch.from_numpy(_keys("uniform", 100))
    ids = torch.arange(100, dtype=torch.int32)
    with pytest.raises(ValueError):
        ms.sort_pass(keys, ids, shift, ms.sort_histogram(keys))
    with pytest.raises(ValueError):
        ms.sort_pass_plain(keys, ids, shift)
