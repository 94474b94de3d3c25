"""flat_roll against the JAX program it ports: exp/probe_flatroll.py,
loaded from its file unchanged, through its own ``interpret=True``,
bitwise on one grid step (8 tiles) of full-range i32 with the extremes.

For k >= 0 (the program's k list, 1024, 1500 and 2^31 - 1) the port
equals the JAX kernel and np.roll. For k < 0 it is held against np.roll
only: the JAX ``flat_roll`` pairs k // 128 (a floor) with rem(k, 128) (a
truncation), so for k = -1 its tile starts [129, 130, ...] where np.roll
gives [1, 2, ...], and for k = -130 [258, ...] against [130, ...]. Then
the program end to end on the CPU, and its check raising on a wrong
kernel.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import load_exp

from tpujoin_torch.kernels import flat_roll as fr
from tpujoin_torch.probes import probe_flatroll
from tpujoin_torch.trace import launches

IMIN, IMAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max
JAX_KS = list(probe_flatroll.CHECK_KS) + [1024, 1500, IMAX]
NEG_KS = [-1, -130, -1024, -1500, IMIN]


@pytest.fixture(scope="module")
def jax_fr():
    return load_exp("probe_flatroll")


def _column(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(IMIN, IMAX, fr.STEP, endpoint=True)
    x[:4] = [IMAX, IMAX, IMIN, -1]
    return x.astype(np.int32)


def _np_flat_roll(x: np.ndarray, ks) -> np.ndarray:
    tiles = x.reshape(-1, fr.TILE).astype(np.int64)
    acc = sum(np.roll(tiles, int(k) % fr.TILE, axis=1) for k in ks)
    return ((acc + 2**31) % 2**32 - 2**31).astype(np.int32).reshape(-1)


def _port(x, ks):
    before = launches["tj_flat_roll"]
    got = fr.flat_roll(torch.from_numpy(x),
                       torch.tensor(ks, dtype=torch.int32), len(ks))
    assert launches["tj_flat_roll"] == before and got.dtype == torch.int32
    return got.numpy()


@pytest.mark.parametrize("k", JAX_KS)
def test_matches_run_one_roll(jax_fr, k):
    x = _column(k % 1000)
    want = np.asarray(jax_fr.run(jnp.asarray(x.reshape(-1, 128)),
                                 jnp.array([k], jnp.int32), 1,
                                 interpret=True)).reshape(-1)
    np.testing.assert_array_equal(_port(x, [k]), want)
    np.testing.assert_array_equal(want, _np_flat_roll(x, [k]))


def test_matches_run_summed_rolls(jax_fr):
    """Four rolls summed: the program's shifts 37, 74, ... and the extremes
    of the k >= 0 list, the sums wrapping."""
    x = _column(7)
    for ks in ([37, 74, 111, 148], [0, 1023, 1500, IMAX]):
        want = np.asarray(jax_fr.run(jnp.asarray(x.reshape(-1, 128)),
                                     jnp.array(ks, jnp.int32), 4,
                                     interpret=True)).reshape(-1)
        np.testing.assert_array_equal(_port(x, ks), want)


@pytest.mark.parametrize("k", NEG_KS)
def test_negative_shift_is_np_roll(k):
    x = _column(3)
    np.testing.assert_array_equal(_port(x, [k]), _np_flat_roll(x, [k]))
    tile = np.arange(fr.TILE, dtype=np.int32)
    got = _port(np.tile(tile, fr.STEP // fr.TILE), [k])[:fr.TILE]
    np.testing.assert_array_equal(got, np.roll(tile, k))


def test_zero_rolls_and_mixed_signs():
    x = _column(11)
    assert not _port(x, []).any()
    ks = [-1, 5, IMIN, IMAX, -130]
    np.testing.assert_array_equal(_port(x, ks), _np_flat_roll(x, ks))


def test_wrapper_refuses_bad_input():
    x = torch.zeros(2 * fr.STEP, dtype=torch.int32)
    s = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        fr.flat_roll(x[:fr.STEP + fr.TILE], s, 1)   # whole tiles, not steps
    with pytest.raises(ValueError, match="rolls"):
        fr.flat_roll(x, s, 5)
    with pytest.raises(ValueError, match="rolls"):
        fr.flat_roll(x, s, -1)
    with pytest.raises(ValueError):
        fr.flat_roll(x, s.long(), 1)
    with pytest.raises(ValueError):
        fr.flat_roll(x.view(-1, 128), s, 1)


def test_probe_flatroll_runs_small_on_cpu(capsys):
    before = launches["tj_flat_roll"]
    assert probe_flatroll.main(["--device", "cpu", "--n", "65536"]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert lines[0]["bench"] == "flat_roll_check" and lines[0]["ok"] is True
    assert [x["rolls"] for x in lines[1:]] == list(probe_flatroll.ROLLS)
    assert all(x["device"] == "cpu" for x in lines)
    assert "k=1023: OK" in out.err and out.err.rstrip().endswith("DONE")
    assert launches["tj_flat_roll"] == before


@pytest.mark.parametrize("wrong_at", ["check", "throughput"])
def test_probe_flatroll_check_raises(monkeypatch, wrong_at):
    def wrong(x, shifts, rolls):
        out = fr.flat_roll(x, shifts, rolls)
        if (x.shape[0] == fr.STEP) == (wrong_at == "check"):
            out[-1] += 1
        return out

    monkeypatch.setattr(probe_flatroll, "flat_roll", wrong)
    with pytest.raises(AssertionError, match="flat_roll"):
        probe_flatroll.main(["--device", "cpu", "--n", "16384"])
