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
