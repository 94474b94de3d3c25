"""The port's Table (tpujoin_torch/core/table.py): the API of the JAX
package's Table, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.core.table import Table as JTable
from tpujoin_torch.core.table import Table


def test_basic_properties():
    t = Table({"key": torch.arange(10, dtype=torch.int32),
               "val": torch.ones(10, dtype=torch.int32)})
    assert t.num_rows == 10 and Table({}).num_rows == 0
    assert t.column_names == ("key", "val")
    assert t["key"].dtype == torch.int32
    assert t.device == torch.device("cpu") and Table({}).device is None


@pytest.mark.parametrize("cols", [
    {"a": torch.zeros(3), "b": torch.zeros(4)},
    {"a": torch.zeros(3), "b": torch.zeros(0)},
])
def test_ragged_rejected(cols):
    with pytest.raises(ValueError):
        Table(cols)


def test_columns_on_two_devices_rejected():
    with pytest.raises(ValueError):
        Table({"a": torch.zeros(3), "b": torch.zeros(3, device="meta")})


def test_gather_select_with_column_match_jax():
    cols = {"key": np.array([5, 6, 7, 8], np.int32),
            "v": np.array([50, 60, 70, 80], np.int32)}
    t = Table.from_numpy(cols, "cpu")
    jt = JTable.from_numpy(cols)
    ids = np.array([2, 0, 3, 3], np.int32)
    g, jg = t.gather(torch.from_numpy(ids)), jt.gather(jnp.asarray(ids))
    for name in cols:
        np.testing.assert_array_equal(g[name].numpy(), np.asarray(jg[name]))
    assert t.select("v").column_names == jt.select("v").column_names
    w = t.with_column("w", torch.arange(4))
    assert w.column_names == ("key", "v", "w") and t.column_names == (
        "key", "v")
    with pytest.raises(ValueError):
        t.with_column("w", torch.arange(5))
    out = t.to_numpy()
    assert set(out) == set(cols)
    for name in cols:
        np.testing.assert_array_equal(out[name], cols[name])
        assert out[name].dtype == cols[name].dtype


def test_arange_index_and_to():
    t = Table.arange_index(5, device="cpu")
    np.testing.assert_array_equal(t["rowid"].numpy(),
                                  np.asarray(JTable.arange_index(5)["rowid"]))
    assert t["rowid"].dtype == torch.int32
    assert t.to("cpu")["rowid"].equal(t["rowid"])
