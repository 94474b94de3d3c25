"""run_variant, the phase ablation of K7 expand_runs, against the JAX
program it ports: exp/profile_expand_runs.py, loaded from its file
unchanged, its pallas_call run in interpret mode. Both columns bitwise
for every variant, on the program's gapless runs at a small size and on
uneven runs whose raw source offset goes negative; then the program end to
end on the CPU.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import load_exp

from tpujoin_torch.kernels import runs_phases as rp
from tpujoin_torch.probes import profile_expand_runs as per
from tpujoin_torch.trace import launches

IMIN, IMAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def jax_per():
    mod = load_exp("profile_expand_runs", interpret=True)
    assert (mod.TILE, mod.BATCH, mod.STEP, mod.META, mod.SRC) == (
        rp.TILE, rp.BATCH, rp.STEP, rp.META, rp.SRC)
    return mod


def _both(jax_per, cols, nonzero, total, capacity, variant):
    np_cols = [c.numpy() for c in cols]
    jr, js = jax_per.run_variant(*(jnp.asarray(c) for c in np_cols),
                                 jnp.asarray([nonzero, total], jnp.int32),
                                 capacity, variant)
    before = launches["tj_run_variant"]
    r, s = rp.run_variant(*cols, nonzero, total, capacity, variant)
    assert launches["tj_run_variant"] == before
    assert r.dtype == s.dtype == torch.int32
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    return r, s


@pytest.mark.parametrize("variant", rp.VARIANTS)
def test_gapless_runs_match_run_variant(jax_per, variant):
    """The JAX program's layout at 300 runs: 30,000 slots, four steps."""
    *cols, k, capacity = per.inputs(300, torch.device("cpu"))
    r, s = _both(jax_per, cols, k, capacity, capacity, variant)
    if variant == "full":
        ok, outside = per.check_full(r, s, cols[1], cols[5], per.DUP,
                                     capacity)
        assert ok and outside == 0


def _uneven():
    """~800 runs of 1-40 slots, random build starts and a full-range
    source, each step's source slab placed so that raw = t0 - off + lo - sb
    is negative for many runs; the total stops 300 slots short of the
    last run's end and 5000 short of the capacity."""
    rng = np.random.default_rng(11)
    counts = rng.integers(1, 41, 800)
    offs = np.cumsum(counts) - counts
    k = len(counts)
    total = int(offs[-1] + counts[-1]) - 300
    capacity = total + 5000
    steps = -(-capacity // rp.STEP)
    offp = np.full(rp.META, IMAX, np.int32)
    offp[:k] = offs
    lop = np.zeros(rp.META, np.int32)
    lop[:k] = rng.integers(0, 6000, k)
    sidp = np.zeros(rp.META, np.int32)
    sidp[:k] = rng.permutation(k)
    src = rng.integers(IMIN, IMAX, 12288, endpoint=True).astype(np.int32)
    meta_base = np.zeros(steps, np.int32)
    src_base = (np.arange(steps) % 3 * 2048 + 1024).astype(np.int32)
    cols = [torch.from_numpy(c) for c in (offp, lop, sidp, src, meta_base,
                                          src_base)]
    return cols, k, total, capacity


@pytest.mark.parametrize("variant", rp.VARIANTS)
def test_uneven_runs_match_run_variant(jax_per, variant):
    cols, k, total, capacity = _uneven()
    rp.check_bases(cols[0], cols[3], cols[4], cols[5], k, capacity)
    r, s = _both(jax_per, cols, k, total, capacity, variant)
    assert (r[total:] == -1).all() and (s[total:] == -1).all()
    t0 = np.arange(capacity) // rp.TILE * rp.TILE
    offs, lo = cols[0].numpy(), cols[1].numpy()
    run = np.searchsorted(offs[:k], np.arange(capacity), "right") - 1
    raw = t0 - offs[run] + lo[run] - cols[5].numpy()[t0 // rp.STEP]
    assert (raw < 0).sum() > 1000      # truncating rem matters here


def _empty_runs_clipped():
    """600 runs of 0-30 slots, about a third of them empty, the first 700
    slots in (the slots before it have no run); only 450 runs count
    (nonzero), though the window's offsets after them still ascend, so
    rel_max = nonzero - 1 - mb clips r1 in the later tiles."""
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 31, 600)
    counts[rng.random(600) < 0.3] = 0
    offs = 700 + np.cumsum(counts) - counts
    k, nonzero = len(counts), 450
    total = int(offs[-1] + counts[-1])
    capacity = total + 1000
    steps = -(-capacity // rp.STEP)
    offp = np.full(rp.META, IMAX, np.int32)
    offp[:k] = offs
    lop = np.zeros(rp.META, np.int32)
    lop[:k] = rng.integers(0, 6000, k)
    sidp = np.zeros(rp.META, np.int32)
    sidp[:k] = rng.permutation(k)
    src = rng.integers(IMIN, IMAX, 12288, endpoint=True).astype(np.int32)
    meta_base = np.zeros(steps, np.int32)
    src_base = (np.arange(steps) % 3 * 2048 + 1024).astype(np.int32)
    cols = [torch.from_numpy(c) for c in (offp, lop, sidp, src, meta_base,
                                          src_base)]
    return cols, offs, nonzero, total, capacity


@pytest.mark.parametrize("variant", rp.VARIANTS)
def test_empty_runs_and_clipped_rel_max_match_run_variant(jax_per, variant):
    cols, offs, nonzero, total, capacity = _empty_runs_clipped()
    assert (np.diff(offs) == 0).sum() > 100
    assert offs[nonzero] < total            # runs past nonzero hold slots
    r, s = _both(jax_per, cols, nonzero, total, capacity, variant)
    if variant == "full":
        assert (r[:offs[0]] == 0).all() and (s[:offs[0]] == 0).all()
        # from the last counted run on, every slot takes that run
        assert (s[offs[nonzero - 1]:total] == int(cols[2][nonzero - 1])).all()


def test_wrapper_refuses_bad_input():
    *cols, k, capacity = per.inputs(300, torch.device("cpu"))
    with pytest.raises(ValueError, match="variant"):
        rp.run_variant(*cols, k, capacity, capacity, "noroll2")
    with pytest.raises(ValueError, match="nonzero"):
        rp.run_variant(*cols, 0, capacity, capacity, "full")
    bad = cols[5].clone()
    bad[1] = cols[3].shape[0] - rp.SRC + 1
    with pytest.raises(ValueError, match="base"):
        rp.check_bases(cols[0], cols[3], cols[4], bad, k, capacity)
    with pytest.raises(ValueError, match="shorter"):
        rp.run_variant(cols[0][:100], *cols[1:], k, capacity, capacity,
                       "full")


def test_profile_expand_runs_runs_small_on_cpu(capsys):
    before = launches["tj_run_variant"]
    assert per.main(["--device", "cpu", "--runs", "3000"]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    assert [x["variant"] for x in lines] == list(rp.VARIANTS)
    assert all(x["bench"] == "run_variant" and x["pairs"] == 300_000
               and x["device"] == "cpu" and x["seconds"] > 0 for x in lines)
    assert "PASS (800 slots' build positions outside" in out.err
    assert out.err.rstrip().endswith("DONE")
    assert launches["tj_run_variant"] == before


def test_profile_expand_runs_check_raises(monkeypatch):
    def wrong(*args):
        r, s = rp.run_variant(*args)
        return r + 1, s

    monkeypatch.setattr(per, "run_variant", wrong)
    with pytest.raises(AssertionError, match="run_variant full"):
        per.main(["--device", "cpu", "--runs", "300"])
