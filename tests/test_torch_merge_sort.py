"""K1, the (key, id) sort of tpujoin_torch, against the JAX package's Pallas
merge sort (interpret mode) and against numpy.

Both sorts may order ids within a run of equal keys differently (the JAX
one is unstable), so ids are compared as a multiset per equal-key run:
the (key, id) pairs sorted lexicographically must be equal. The exact
tolerance holds everywhere: all outputs are integers.

The JAX calls share one width (N) and tile (T) so the module compiles its
interpret-mode kernels once.
"""
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


@pytest.mark.parametrize("dist,n", [
    ("uniform", N), ("dup8", N), ("all_equal", N), ("reversed", N),
    ("uniform", N - 77),   # ragged: the JAX sort pads to N
])
def test_matches_jax_sort_pairs(dist, n):
    keys = _keys(dist, n)
    ids = np.arange(n, dtype=np.int32)
    jk, ji = jax_ms.sort_pairs(jnp.asarray(keys), jnp.asarray(ids),
                               run_len0=T, t_out=T, interpret=True)
    jk, ji = np.asarray(jk), np.asarray(ji)
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


def test_passes_sort_runs_and_leave_inputs():
    keys = torch.from_numpy(_keys("dup8", 3 * ms.TILE + 5, seed=1))
    ids = torch.arange(keys.shape[0], dtype=torch.int32)
    before = keys.clone()
    k, i = ms.block_sort(keys, ids)
    for lo in range(0, keys.shape[0], ms.TILE):
        assert bool((k[lo:lo + ms.TILE].diff() >= 0).all())
    k2, i2 = ms.merge_pass(k, i, ms.TILE)
    assert bool((k2[:2 * ms.TILE].diff() >= 0).all())
    assert bool((k2[2 * ms.TILE:].diff() >= 0).all())
    assert torch.equal(keys, before)
    with pytest.raises(ValueError):
        ms.merge_pass(k, i, ms.TILE + 1)
