"""The port's filter and nested-loop join (tpujoin_torch/ops/filter.py,
ops/nested_loop_join.py) against the JAX package's, on the same numpy
inputs, on the CPU: row ids bitwise, totals exact, tables column for
column, join pairs as an exact multiset through the native oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpujoin.ops.filter as jflt
from tpujoin import oracle as jax_oracle
from tpujoin.core.table import Table as JTable
from tpujoin.ops.nested_loop_join import materialize_join_rows as jax_rows
from tpujoin.ops.nested_loop_join import nested_loop_join as jax_nlj
from tpujoin_torch import oracle
from tpujoin_torch.core.table import Table
from tpujoin_torch.ops import filter as flt
from tpujoin_torch.ops import nested_loop_join as nlj


def _vals(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 160, n).astype(np.float32)


@pytest.mark.parametrize("n,capacity", [(4096, 4096), (5000, 1024),
                                        (1000, 2048)])
def test_filter_materialize_matches_jax(n, capacity):
    vals = _vals(n, n)
    mask = vals < 80.0
    ids, total = jflt.filter_materialize(jnp.asarray(mask), capacity)
    got, got_total = flt.filter_materialize(torch.from_numpy(mask), capacity)
    assert int(flt.filter_count(torch.from_numpy(mask))) == int(
        jflt.filter_count(jnp.asarray(mask))) == int(mask.sum())
    assert int(got_total) == int(total)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ids))


def test_filter_device_matches_jax():
    vals = _vals(3000, 1)
    ids, total = jflt.filter_device(jnp.asarray(vals), 80.0, capacity=4096)
    got, got_total = flt.filter_device(vals, 80.0, 4096, device="cpu")
    assert int(got_total) == int(total)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ids))
    got_t, _ = flt.filter_device(torch.from_numpy(vals), 80.0, 4096)
    assert torch.equal(got_t, got)


def _tables(n: int, seed: int):
    rng = np.random.default_rng(seed)
    cols = {"val": _vals(n, seed),
            "rowid": np.arange(n, dtype=np.int32),
            "payload": rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
            .astype(np.int32)}
    return cols, JTable({k: jnp.asarray(v) for k, v in cols.items()})


@pytest.mark.parametrize("threshold,expect", [(80.0, None), (-1.0, 0),
                                              (1e9, 2500)])
def test_filter_table_matches_jax(threshold, expect):
    """Three columns; half kept, nothing kept, everything kept."""
    cols, jt = _tables(2500, 7)
    want = jflt.filter_table(jt, lambda v: v < threshold, "val",
                             pad_multiple=256)
    got = flt.filter_table(Table.from_numpy(cols, "cpu"),
                           lambda v: v < threshold, "val", pad_multiple=256)
    assert got.column_names == tuple(cols)
    if expect is not None:
        assert got.num_rows == want.num_rows == expect
    for name in cols:
        assert got[name].dtype == torch.from_numpy(cols[name]).dtype
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    as_numpy = flt.filter_table(cols, lambda v: v < threshold, "val",
                                device="cpu", return_numpy=True)
    for name in cols:
        np.testing.assert_array_equal(as_numpy[name], got[name].numpy())


def test_filter_preserves_order():
    t = Table({"val": torch.tensor([5, 90, 3, 91, 4], dtype=torch.float32),
               "rowid": torch.arange(5, dtype=torch.int32)})
    out = flt.filter_table(t, lambda v: v < 80.0, "val", pad_multiple=8)
    assert out["rowid"].tolist() == [0, 2, 4]


@pytest.mark.parametrize("n,m,dom", [(300, 200, 50), (257, 1031, 40),
                                     (64, 64, 10**6)])
def test_nested_loop_join_matches_jax_and_oracle(n, m, dom):
    rng = np.random.default_rng(n + m)
    rk = rng.integers(1, dom, n).astype(np.int32)
    sk = rng.integers(1, dom, m).astype(np.int32)
    r, s = nlj.nested_loop_join(rk, sk, device="cpu", pad_multiple=1024)
    jr, js = jax_nlj(rk, sk, pad_multiple=1024)
    # both compact the row-major equality mask: the same pairs in the same
    # order
    np.testing.assert_array_equal(r, np.asarray(jr))
    np.testing.assert_array_equal(s, np.asarray(js))
    assert r.dtype == s.dtype == np.int32
    if len(r):
        assert oracle.check_join(rk, sk, r, s, nested=True) == 1
        assert jax_oracle.check_join(rk, sk, r, s, nested=True) == 1
    assert int(nlj.nested_loop_count(torch.from_numpy(rk),
                                     torch.from_numpy(sk))) == len(r)


def test_nested_loop_materialize_pads_with_minus_one():
    rk = torch.tensor([1, 2, 2], dtype=torch.int32)
    sk = torch.tensor([2, 3, 2, 1], dtype=torch.int32)
    r, s, total = nlj.nested_loop_materialize(rk, sk, 8)
    assert int(total) == 5
    assert r.tolist() == [0, 1, 1, 2, 2, -1, -1, -1]
    assert s.tolist() == [3, 0, 2, 0, 2, -1, -1, -1]
    r, s, total = nlj.nested_loop_materialize(rk, sk[:0], 4)
    assert int(total) == 0 and r.tolist() == s.tolist() == [-1] * 4


def test_materialize_join_rows_matches_jax():
    r = {"key": np.array([1, 2, 3], np.int32),
         "a": np.array([10, 20, 30], np.int32)}
    s = {"key": np.array([2, 3, 2], np.int32),
         "b": np.array([200, 300, 201], np.int32)}
    r_ids, s_ids = nlj.nested_loop_join(r["key"], s["key"], device="cpu",
                                        pad_multiple=16)
    got = nlj.materialize_join_rows(Table.from_numpy(r, "cpu"),
                                    Table.from_numpy(s, "cpu"), r_ids, s_ids)
    want = jax_rows(JTable({k: jnp.asarray(v) for k, v in r.items()}),
                    JTable({k: jnp.asarray(v) for k, v in s.items()}),
                    r_ids, s_ids)
    assert got.column_names == ("r_key", "r_a", "s_b")
    assert set(got.column_names) == set(want.column_names)
    for name in got.column_names:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
