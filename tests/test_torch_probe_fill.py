"""fill_forward and scatter_markers against the JAX program they port:
exp/probe_fill.py, loaded from its file unchanged, its pallas_call run in
interpret mode. The filled column bitwise over several steps, with leading
empty slots and an empty stretch across a step boundary; the marker
scatter bitwise; then the program end to end on the CPU.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import load_exp

from tpujoin_torch.kernels import forward_fill as ff
from tpujoin_torch.probes import probe_fill
from tpujoin_torch.trace import launches

LANES = 128


@pytest.fixture(scope="module")
def jax_pf():
    return load_exp("probe_fill", interpret=True)


def _marks(n: int, seed: int) -> np.ndarray:
    """n slots: 700 leading -1s, markers (probe ids >= 0) every 1-300
    slots, other negative values in between, and no marker in
    [14000, 40000), a stretch across the step boundary at 16384 and 32768."""
    rng = np.random.default_rng(seed)
    mark = np.full(n, -1, np.int32)
    at = np.cumsum(rng.integers(1, 301, n))
    at = at[(at >= 700) & (at < n)]
    at = at[(at < 14000) | (at >= 40000)]
    mark[at] = rng.integers(0, 1 << 30, len(at))
    mark[rng.integers(0, n, n // 50)] = -7
    mark[700] = 0
    return mark


@pytest.mark.parametrize("step,steps", [(16384, 3), (32768, 2)])
def test_matches_fill_forward(jax_pf, step, steps):
    mark = _marks(step * steps, step).reshape(-1, LANES)
    want = np.asarray(jax_pf.fill_forward(jnp.asarray(mark), step))
    before = launches["tj_fill_forward"]
    got = ff.fill_forward(torch.from_numpy(mark), step)
    assert launches["tj_fill_forward"] == before
    assert got.shape == mark.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    flat = want.reshape(-1)
    assert (flat[:700] == -1).all() and flat[700] == 0
    assert (flat[14000:40000] == flat[13999]).all()


def test_plain_carries_across_its_chunks(monkeypatch):
    """The plain version's blocked cummax against a numpy loop, with
    chunks of two rows and the carry crossing rows and chunks."""
    mark = _marks(5 * ff.SUB, 3)
    monkeypatch.setattr(ff, "PLAIN_CHUNK", 2 * ff.SUB)
    got = ff.fill_forward(torch.from_numpy(mark.reshape(-1, LANES)),
                          ff.SUB).reshape(-1).numpy()
    want, last = np.empty_like(mark), -1
    for t, v in enumerate(mark):
        last = v if v >= 0 else last
        want[t] = last
    np.testing.assert_array_equal(got, want)


def test_matches_scatter_markers(jax_pf):
    rng = np.random.default_rng(8)
    counts = rng.integers(1, 50, 3000)
    offs = (np.cumsum(counts) - counts).astype(np.int32)
    sid = rng.permutation(3000).astype(np.int32)
    nonzero, cap = 2500, 1 << 17
    want = np.asarray(jax_pf.scatter_markers(
        jnp.asarray(offs), jnp.asarray(sid), jnp.int32(nonzero), cap))
    got = ff.scatter_markers(torch.from_numpy(offs), torch.from_numpy(sid),
                             nonzero, cap)
    assert got.shape == (cap // LANES, LANES)
    np.testing.assert_array_equal(got.numpy(), want)
    # an offset at or past the capacity is dropped
    short = ff.scatter_markers(torch.from_numpy(offs), torch.from_numpy(sid),
                               3000, 1 << 16).reshape(-1).numpy()
    keep = offs < (1 << 16)
    assert (short[offs[keep]] == sid[keep]).all()
    assert (short >= 0).sum() == keep.sum()


def test_wrapper_refuses_bad_shapes():
    x = torch.full((384, LANES), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="step"):
        ff.fill_forward(x, 4096)         # not a multiple of SUB
    with pytest.raises(ValueError, match="step"):
        ff.fill_forward(x, 32768)        # does not divide the slots
    with pytest.raises(ValueError, match="rows"):
        ff.fill_forward(x.reshape(-1), 16384)


def test_probe_fill_runs_small_on_cpu(capsys):
    before = launches["tj_fill_forward"]
    assert probe_fill.main(["--device", "cpu", "--rows", "20000",
                            "--key-max", "200"]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert [x["bench"] for x in lines] == [
        "scatter_markers", "fill_forward", "fill_forward", "fill_forward",
        "fill_forward_parity"]
    assert [x.get("step") for x in lines[1:]] == [16384, 32768, 65536, 32768]
    assert lines[-1]["ok"] is True and lines[-1]["slots"] == lines[1]["pairs"]
    assert all(x["device"] == "cpu" for x in lines)
    assert "parity on all" in out.err and out.err.rstrip().endswith("DONE")
    assert launches["tj_fill_forward"] == before


def test_probe_fill_check_raises(monkeypatch):
    def wrong(mark2d, step):
        out = ff.fill_forward(mark2d, step)
        out.view(-1)[5] += 1
        return out

    monkeypatch.setattr(probe_fill, "fill_forward", wrong)
    with pytest.raises(AssertionError, match="fill_forward"):
        probe_fill.main(["--device", "cpu", "--rows", "5000",
                         "--key-max", "100"])
