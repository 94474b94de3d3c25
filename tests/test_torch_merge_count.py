"""K2, tpujoin_torch's merge count, against the JAX package's Pallas
merge_count (interpret mode, both of its launches): lo and cnt bitwise.

All cases share one (build, probe) width so each JAX launch compiles once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.kernels.merge_count import merge_count as jax_merge_count
from tpujoin_torch.kernels import merge_count as mc


N = M = 4096


def _case(name: str, n: int = N, m: int = M, seed: int = 0):
    rng = np.random.default_rng(seed)
    if name == "uniform":          # ~half the probe keys match
        b = rng.integers(1, 2 * n + 2, n)
        p = rng.integers(1, 2 * n + 2, m)
    elif name == "outside":        # below, between and above the build keys
        # (fewer than one 1024-key JAX tile above the build keys: see
        # test_lo_is_n_above_every_build_key)
        b = rng.integers(1000, 2000, n) * 2
        p = rng.integers(0, 4600, m)
    elif name == "all_equal":
        b = np.full(n, 5)
        p = np.concatenate([np.full(m // 2, 5), rng.integers(0, 10, m // 2)])
    elif name == "dups":           # long runs on both sides
        b = rng.integers(1, 40, n)
        p = rng.integers(0, 45, m)
    else:
        raise ValueError(name)
    return np.sort(b).astype(np.int32), np.sort(p).astype(np.int32)


CASES = ["uniform", "outside", "all_equal", "dups"]


@pytest.mark.parametrize("big", [False, True], ids=["small_m", "big_m"])
@pytest.mark.parametrize("name", CASES)
def test_matches_jax_merge_count(name, big):
    b, p = _case(name)
    # smem_tile_budget=1 sends the JAX call through its big-m launch
    jlo, jcnt = jax_merge_count(jnp.asarray(b), jnp.asarray(p),
                                interpret=True,
                                smem_tile_budget=1 if big else None)
    lo, cnt = mc.merge_count(torch.from_numpy(b), torch.from_numpy(p))
    assert lo.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


IMIN = np.iinfo(np.int32).min
IMAX = np.iinfo(np.int32).max


def _zipf(rng, size: int, key_max: int = 10**6) -> np.ndarray:
    """Zipf(1.0)-like keys over [1, key_max] (log-uniform, key 1 the most
    frequent), zipf_skew's shape."""
    return np.exp(rng.random(size) * np.log(key_max)).astype(
        np.int64).clip(1, key_max)


def _skew_case(name: str, seed: int = 5):
    """The card kernel's hazards at small sizes: its path tiles hold
    merge_count.TILE (4096) keys of both columns together."""
    rng = np.random.default_rng(seed)
    if name == "one_run":          # build and probe runs over tiles
        b = np.concatenate([rng.integers(1, 100, 1096), np.full(7096, 50)])
        p = np.concatenate([rng.integers(0, 101, 4096), np.full(4096, 50)])
    elif name == "n_much_larger":
        b, p = rng.integers(1, 10**6, 4096), rng.integers(1, 10**6, 300)
    elif name == "m_much_larger":
        b, p = rng.integers(1, 10**6, 300), rng.integers(1, 10**6, 4096)
    elif name == "int32_min":      # the least key on both sides
        b = rng.choice(np.array([IMIN, IMIN + 1, -5, 0, 7]), 4096)
        p = rng.choice(np.array([IMIN, IMIN + 1, -6, -5, 0, 8]), 4096)
    elif name == "zipf":
        b, p = _zipf(rng, 4096), _zipf(rng, 4096)
    else:
        raise ValueError(name)
    return np.sort(b).astype(np.int32), np.sort(p).astype(np.int32)


def _numpy_count(b, p):
    lo = np.searchsorted(b, p, "left")
    return lo, np.searchsorted(b, p, "right") - lo


SKEW = ["one_run", "n_much_larger", "m_much_larger", "int32_min", "zipf"]


@pytest.mark.parametrize("big", [False, True], ids=["small_m", "big_m"])
@pytest.mark.parametrize("name", SKEW)
def test_skew_matches_jax_and_numpy(name, big):
    """Skewed shapes inside the JAX kernel's preconditions (no INT32_MAX
    key): the port's plain version bitwise against the Pallas kernel in
    interpret mode and against numpy."""
    b, p = _skew_case(name)
    jlo, jcnt = jax_merge_count(jnp.asarray(b), jnp.asarray(p),
                                interpret=True,
                                smem_tile_budget=1 if big else None)
    lo, cnt = mc.merge_count(torch.from_numpy(b), torch.from_numpy(p))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    want_lo, want_cnt = _numpy_count(b, p)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)


def _edge_case(name: str):
    rng = np.random.default_rng(11)
    if name == "extremes":         # INT32_MIN and INT32_MAX on both sides
        b = rng.choice(np.array([IMIN, IMIN + 1, 0, IMAX - 1, IMAX]), 3001)
        p = rng.choice(np.array([IMIN, -1, 0, IMAX - 2, IMAX - 1, IMAX]), 2049)
    elif name == "empty_build":
        b, p = np.zeros(0), rng.integers(-5, 5, 100)
    elif name == "empty_probe":
        b, p = rng.integers(-5, 5, 100), np.zeros(0)
    elif name == "one_build":
        b, p = np.array([3]), rng.integers(0, 7, 2049)
    else:
        raise ValueError(name)
    return np.sort(b).astype(np.int32), np.sort(p).astype(np.int32)


@pytest.mark.parametrize("name", ["extremes", "empty_build", "empty_probe",
                                  "one_build"])
def test_plain_matches_numpy_on_edges(name):
    """Outside the JAX kernel's domain (INT32_MAX keys) or at empty and
    one-key sides: numpy only."""
    b, p = _edge_case(name)
    lo, cnt = mc.merge_count(torch.from_numpy(b), torch.from_numpy(p))
    assert lo.dtype == cnt.dtype == torch.int32 and lo.shape == p.shape
    want_lo, want_cnt = _numpy_count(b, p)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)


def test_plain_matches_numpy_on_ragged_widths():
    b, p = _case("dups", n=1001, m=777, seed=3)
    lo, cnt = mc.merge_count(torch.from_numpy(b), torch.from_numpy(p))
    np.testing.assert_array_equal(lo.numpy(), np.searchsorted(b, p, "left"))
    np.testing.assert_array_equal(
        cnt.numpy(), np.searchsorted(b, p, "right") - np.searchsorted(b, p))


def test_lo_is_n_above_every_build_key():
    """lo is the lower bound even for a probe key above every build key.
    The JAX kernel returns n - 1024 there (0 in this case) when n is a
    multiple of its 1024-key chunk and a whole probe tile lies above the
    build keys: its window start is clamped before the scan."""
    b = np.ones(1024, np.int32)
    p = np.full(1024, 2, np.int32)
    lo, cnt = mc.merge_count(torch.from_numpy(b), torch.from_numpy(p))
    assert (lo.numpy() == 1024).all() and not cnt.numpy().any()


def test_probe_key_int32_max_counts_only_real_keys():
    """A probe key INT32_MAX counts the build keys equal to it and no
    more. The JAX kernel pads the build keys with INT32_MAX, so on sorted
    build [3, IMAX, IMAX], probe [3, IMAX] it gives lo [0, 1] and cnt
    [1, 1023]: the real pair and every pad of its 1024-key tile."""
    imax = np.iinfo(np.int32).max
    b = np.array([3, imax, imax], np.int32)
    p = np.array([3, imax], np.int32)
    lo, cnt = mc.merge_count(torch.from_numpy(b), torch.from_numpy(p))
    np.testing.assert_array_equal(lo.numpy(), np.searchsorted(b, p, "left"))
    np.testing.assert_array_equal(
        cnt.numpy(), np.searchsorted(b, p, "right") - np.searchsorted(b, p))
    assert cnt.tolist() == [1, 2]
