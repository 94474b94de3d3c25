"""The port's sort and radix partitioning (tpujoin_torch/ops/sort.py,
ops/radix.py) against the JAX package's, on the same numpy inputs, on the
CPU: every output bitwise (the sorts are stable on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.core.table import Table as JTable
from tpujoin.ops import radix as jradix
from tpujoin.ops import sort as jsort
from tpujoin_torch.core.table import Table
from tpujoin_torch.ops import radix, sort

IMIN, IMAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _keys(kind: str, n: int = 5000) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "full":
        return rng.integers(IMIN, IMAX, n, endpoint=True).astype(np.int32)
    if kind == "dup":
        return rng.integers(-4, 5, n).astype(np.int32)
    return rng.choice(np.array([IMIN, IMIN + 1, -1, 0, 1, IMAX - 1, IMAX],
                               np.int32), n)


def test_hash32_bit_identical_to_jax():
    keys = np.concatenate([
        np.array([IMIN, IMIN + 1, -1, 0, 1, 42, IMAX - 1, IMAX], np.int32),
        _keys("full", 20_000)])
    got = radix.hash32(torch.from_numpy(keys))
    want = np.asarray(jradix.hash32(jnp.asarray(keys)))
    assert want.dtype == np.uint32 and got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("num_partitions", [1, 8, 13, 1024])
def test_partition_ids_match_jax(num_partitions):
    keys = _keys("full")
    got = radix.partition_ids(torch.from_numpy(keys), num_partitions)
    want = jradix.partition_ids(jnp.asarray(keys), num_partitions)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["full", "dup", "extremes"])
def test_radix_partition_matches_jax_and_is_csr(kind):
    keys = _keys(kind, 2048)
    ids = np.arange(2048, dtype=np.int32)
    p = 16
    got = radix.radix_partition(torch.from_numpy(keys), torch.from_numpy(ids),
                                p)
    want = jradix.radix_partition(jnp.asarray(keys), jnp.asarray(ids), p)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pkeys, pids, offsets, counts = (g.numpy() for g in got)
    assert counts.sum() == 2048
    np.testing.assert_array_equal(offsets, np.cumsum(counts) - counts)
    np.testing.assert_array_equal(np.sort(pids), ids)
    np.testing.assert_array_equal(keys[pids], pkeys)
    part = radix.partition_ids(torch.from_numpy(keys), p).numpy()
    for q in range(p):
        assert (part[pids[offsets[q]:offsets[q] + counts[q]]] == q).all()


@pytest.mark.parametrize("kind", ["full", "dup", "extremes"])
@pytest.mark.parametrize("bits", [8, 11])
def test_radix_sort_matches_jax(kind, bits):
    keys = _keys(kind)
    got = radix.radix_sort(torch.from_numpy(keys), bits)
    want = jradix.radix_sort(jnp.asarray(keys), bits)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), np.sort(keys))


@pytest.mark.parametrize("kind", ["full", "dup", "extremes"])
def test_sort_with_ids_matches_jax(kind):
    keys = _keys(kind)
    sk, perm = sort.sort_with_ids(torch.from_numpy(keys))
    jk, jperm = jsort.sort_with_ids(jnp.asarray(keys))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


def test_sort_by_key_matches_jax():
    rng = np.random.default_rng(3)
    cols = {"v": rng.integers(0, 100, 3000).astype(np.int32),
            "key": _keys("dup", 3000),
            "w": rng.random(3000).astype(np.float32)}
    got = sort.sort_by_key(Table.from_numpy(cols, "cpu"))
    want = jsort.sort_by_key(JTable({k: jnp.asarray(v)
                                     for k, v in cols.items()}))
    assert got.column_names == want.column_names == ("key", "v", "w")
    for name in cols:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
