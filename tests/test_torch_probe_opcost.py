"""select_chain against the JAX program it ports: exp/probe_opcost.py,
loaded from its file unchanged, its pallas_call run in interpret mode,
bitwise on three blocks of full-range i32 with the extremes. The shifts
are the program's (37, 74, ...) or full-range with the extremes, so the
compare meets negative shifts and the adds wrap. Then the program end to
end on the CPU, and its check raising on a wrong kernel.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import load_exp

from tpujoin_torch.kernels import select_chain as sc
from tpujoin_torch.probes import probe_opcost
from tpujoin_torch.trace import launches

IMIN, IMAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max
BLOCKS = 3


@pytest.fixture(scope="module")
def jax_po():
    return load_exp("probe_opcost", interpret=True)


def _inputs(rows: int, ops: int, shifts: str):
    rng = np.random.default_rng(rows * 100 + ops)
    x = rng.integers(IMIN, IMAX, BLOCKS * rows * sc.LANES, endpoint=True)
    x[:4] = [IMAX, IMIN, -1, IMAX]
    if shifts == "program":
        s = np.arange(1, ops + 1) * probe_opcost.SHIFT
    else:
        s = rng.integers(IMIN, IMAX, ops, endpoint=True)
        s[:3] = [5, IMAX, IMIN][:ops]
    return x.astype(np.int32), s.astype(np.int32)


@pytest.mark.parametrize("shifts", ["program", "full_range"])
@pytest.mark.parametrize("ops", [1, 9])
@pytest.mark.parametrize("rows", [8, 32])
def test_matches_run(jax_po, rows, ops, shifts):
    x, s = _inputs(rows, ops, shifts)
    want = np.asarray(jax_po.run(jnp.asarray(x.reshape(-1, sc.LANES)),
                                 jnp.asarray(s), ops, rows)).reshape(-1)
    before = launches["tj_select_chain"]
    got = sc.select_chain(torch.from_numpy(x), torch.from_numpy(s), ops, rows)
    assert launches["tj_select_chain"] == before and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, x)


def test_plain_matches_numpy_and_closed_form():
    """A numpy loop in int64, wrapped, at ops 0 and 33 and a shift past
    the block; the program's closed form on ones."""
    x, s = _inputs(8, 33, "full_range")
    s[5] = 2000
    u = np.tile(np.arange(8 * sc.LANES), BLOCKS)
    for ops in (0, 33):
        acc = x.astype(np.int64)
        for c in s[:ops].astype(np.int64):
            acc = np.where(u >= c, acc + c, acc)
        want = ((acc + 2**31) % 2**32 - 2**31).astype(np.int32)
        got = sc.select_chain(torch.from_numpy(x), torch.from_numpy(s), ops, 8)
        np.testing.assert_array_equal(got.numpy(), want)
    ones = torch.ones(BLOCKS * 64 * sc.LANES, dtype=torch.int32)
    shifts = torch.arange(1, 34, dtype=torch.int32) * probe_opcost.SHIFT
    got = sc.select_chain(ones, shifts, 33, 64).view(BLOCKS, -1)
    assert torch.equal(got, probe_opcost.expected_block(64, 33, "cpu")
                       .expand(BLOCKS, -1))


def test_wrapper_refuses_bad_input():
    x = torch.zeros(8 * sc.LANES * 2, dtype=torch.int32)
    s = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        sc.select_chain(x[:-128], s, 1, 8)      # a ragged block
    with pytest.raises(ValueError, match="multiple"):
        sc.select_chain(x, s, 1, 0)
    with pytest.raises(ValueError, match="ops"):
        sc.select_chain(x, s, 5, 8)             # more ops than shifts
    with pytest.raises(ValueError, match="ops"):
        sc.select_chain(x, s, -1, 8)
    with pytest.raises(ValueError):
        sc.select_chain(x.long(), s, 1, 8)
    with pytest.raises(ValueError):
        sc.select_chain(x.view(-1, sc.LANES), s, 1, 8)


def test_probe_opcost_runs_small_on_cpu(capsys):
    before = launches["tj_select_chain"]
    assert probe_opcost.main(["--device", "cpu", "--n", "32768"]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert [(x["rows"], x["ops"]) for x in lines] == [
        (r, o) for r in probe_opcost.BLOCK_ROWS for o in probe_opcost.OPS]
    assert all(x["device"] == "cpu" and x["n"] == 32768 for x in lines)
    assert lines[0]["marginal_ns_per_op"] is None
    assert lines[1]["marginal_ns_per_op"] is not None
    assert "R=128 ops=33" in out.err and out.err.rstrip().endswith("DONE")
    assert launches["tj_select_chain"] == before


def test_probe_opcost_check_raises(monkeypatch):
    def wrong(x, shifts, ops, rows):
        out = sc.select_chain(x, shifts, ops, rows)
        out[-1] += 1
        return out

    monkeypatch.setattr(probe_opcost, "select_chain", wrong)
    with pytest.raises(AssertionError, match="closed form"):
        probe_opcost.main(["--device", "cpu", "--n", "16384"])
