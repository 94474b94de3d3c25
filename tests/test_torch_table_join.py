"""join_tables and table I/O of tpujoin_torch against the JAX package's
(tpujoin.ops.table_join, tpujoin.core.io) on the same numpy inputs (the
cases of tests/test_table_join.py and tests/test_io.py).

Comparisons: each result table's columns bitwise after its rows are sorted
by (s id, r id), where ids are columns the inputs carry; semi and anti
results bitwise as they come (S rows ascending); loaded tables bitwise,
across the two packages in both directions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.core import io as jax_io
from tpujoin.core.table import Table as JaxTable
from tpujoin.ops.table_join import join_tables as jax_join_tables
from tpujoin_torch import join_tables, merge_join, oracle
from tpujoin_torch.core import io
from tpujoin_torch.core.table import Table


def _tables(seed=0, n=400, m=600, dom=50):
    rng = np.random.default_rng(seed)
    r = {"key": rng.integers(1, dom, n).astype(np.int32),
         "k2": rng.integers(1, 4, n).astype(np.int32),
         "a": rng.integers(0, 1000, n).astype(np.int32),
         "rid": np.arange(n, dtype=np.int32)}
    s = {"key": rng.integers(1, dom, m).astype(np.int32),
         "k2": rng.integers(1, 4, m).astype(np.int32),
         "b": rng.random(m).astype(np.float32),
         "sid": np.arange(m, dtype=np.int32)}
    return r, s


def _jax(cols):
    return JaxTable({k: jnp.asarray(v) for k, v in cols.items()})


def _sorted(cols: dict) -> dict:
    cols = {k: np.asarray(v) for k, v in cols.items()}
    if "s_sid" in cols:
        order = np.lexsort((cols["r_rid"], cols["s_sid"]))
        cols = {k: v[order] for k, v in cols.items()}
    return cols


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("on", ["key", ["key", "k2"]])
@pytest.mark.parametrize("dom", [50, 120])
def test_join_tables_matches_jax(how, on, dom):
    r, s = _tables(dom=dom)
    got = join_tables(r, s, on, how=how, device="cpu")
    want = jax_join_tables(_jax(r), _jax(s), on, how=how)
    g, w = _sorted(got.to_numpy()), _sorted(want.to_numpy())
    assert set(g) == set(w)
    for name in w:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    if how in ("inner", "left"):
        assert "s_key" not in g and "r_key" in g


def test_join_tables_on_tables_and_tensors():
    """Port Tables stay on their device; the inner rows pair up by key."""
    r, s = _tables(seed=1)
    rt, st = Table.from_numpy(r, "cpu"), Table.from_numpy(s, "cpu")
    out = join_tables(rt, st, "key")
    assert out.device.type == "cpu"
    assert out.num_rows == int((r["key"][:, None] == s["key"][None, :]).sum())
    np.testing.assert_array_equal(out["r_key"].numpy(),
                                  s["key"][out["s_sid"].numpy()])
    with pytest.raises(ValueError, match="how"):
        join_tables(rt, st, "key", how="full")


@pytest.fixture
def table_np():
    rng = np.random.default_rng(0)
    return {"key": rng.integers(1, 100, 1000).astype(np.int32),
            "val": rng.uniform(0, 1, 1000).astype(np.float32),
            "flag": rng.random(1000) < 0.5}


def _equal_cols(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        assert np.asarray(got[name]).dtype == np.asarray(want[name]).dtype
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]))


def test_npz_roundtrip(table_np, tmp_path):
    io.save_table_npz(Table.from_numpy(table_np, "cpu"), tmp_path / "t.npz")
    back = io.load_table_npz(tmp_path / "t.npz", device="cpu")
    assert back.device.type == "cpu"
    _equal_cols(back.to_numpy(), table_np)


@pytest.mark.parametrize("mmap", [True, False])
def test_dir_roundtrip(table_np, tmp_path, mmap):
    io.save_table_dir(Table.from_numpy(table_np, "cpu"), tmp_path / "tdir")
    back = io.load_table_dir(tmp_path / "tdir", mmap=mmap, device="cpu")
    assert back.num_rows == 1000
    _equal_cols(back.to_numpy(), table_np)


def test_mapped_columns_leave_the_files_unchanged(table_np, tmp_path):
    """A mapped column is copy-on-write: a write to its tensor never
    reaches the file."""
    io.save_table_dir(Table.from_numpy(table_np, "cpu"), tmp_path / "tdir")
    back = io.load_table_dir(tmp_path / "tdir", device="cpu")
    back["key"][:10] = -5
    again = io.load_table_dir(tmp_path / "tdir", device="cpu")
    np.testing.assert_array_equal(again["key"].numpy(), table_np["key"])


@pytest.mark.parametrize("fmt", ["npz", "dir"])
def test_files_cross_between_the_packages(table_np, tmp_path, fmt):
    """A table the JAX package writes loads in the port, and the
    reverse."""
    jt = JaxTable.from_numpy(table_np)
    pt = Table.from_numpy(table_np, "cpu")
    if fmt == "npz":
        jax_io.save_table_npz(jt, tmp_path / "j.npz")
        io.save_table_npz(pt, tmp_path / "p.npz")
        from_jax = io.load_table_npz(tmp_path / "j.npz", device="cpu")
        from_port = jax_io.load_table_npz(tmp_path / "p.npz")
    else:
        jax_io.save_table_dir(jt, tmp_path / "j")
        io.save_table_dir(pt, tmp_path / "p")
        from_jax = io.load_table_dir(tmp_path / "j", device="cpu")
        from_port = jax_io.load_table_dir(tmp_path / "p")
    _equal_cols(from_jax.to_numpy(), table_np)
    _equal_cols(from_port.to_numpy(), table_np)


def test_loaded_table_joins(table_np, tmp_path):
    io.save_table_dir(Table.from_numpy(table_np, "cpu"), tmp_path / "tdir")
    back = io.load_table_dir(tmp_path / "tdir", device="cpu")
    rk = table_np["key"]
    r_ids, s_ids = merge_join(back["key"], torch.from_numpy(rk),
                              result_pad_multiple=4096)
    assert oracle.check_join(rk, rk, r_ids, s_ids) == 1
