"""The port's group-by aggregate (tpujoin_torch/ops/aggregate.py) against
the JAX package's and the native oracle, on the same numpy inputs, on the
CPU. Keys, counts, mins and maxs bitwise over the whole capacity; sums as
exact int64 against the JAX pair (hi << 32) | lo. The JAX value path is run
in both its forms: the gather form and the kernel form (compact_step=1024,
one 6-column compact_cols pass in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin import oracle as jax_oracle
from tpujoin.ops import aggregate as jagg
from tpujoin_torch import oracle
from tpujoin_torch.ops import aggregate as agg

N = 8192   # one width for the JAX kernel form: one compile per capacity


def _combine(hi, lo) -> np.ndarray:
    return ((np.asarray(hi).astype(np.int64) << 32)
            | np.asarray(lo).astype(np.uint32).astype(np.int64))


def _case(name: str):
    rng = np.random.default_rng(len(name))
    if name == "negative":
        keys = rng.integers(0, 700, N)
        vals = rng.integers(-1_000_000, 1_000_000, N)
    elif name == "past_2^31":    # every group sums far past 2^31
        keys = rng.integers(1, 50, N)
        vals = rng.integers(2**31 - 10**6, 2**31 - 1, N)
    elif name == "one_group":    # i32 extremes, sum ~ +-2^43
        keys = np.full(N, 7)
        vals = rng.integers(-2**31, 2**31 - 1, N)
    else:                        # all keys distinct, negative keys too
        keys = rng.permutation(N) - 4000
        vals = rng.integers(-5, 5, N)
    return keys.astype(np.int32), vals.astype(np.int32)


CASES = [("negative", 1024), ("past_2^31", 1024), ("one_group", 1024),
         ("distinct", N)]


@pytest.mark.parametrize("name,cap", CASES)
def test_group_agg_materialize_matches_jax_both_forms(name, cap):
    keys, vals = _case(name)
    got = agg.group_agg_materialize(torch.from_numpy(keys),
                                    torch.from_numpy(vals), cap)
    assert got[2].dtype == torch.int64
    gather = jagg.group_agg_materialize(jnp.asarray(keys), jnp.asarray(vals),
                                        cap)
    kernel = jagg.group_agg_materialize(jnp.asarray(keys), jnp.asarray(vals),
                                        cap, compact_step=1024)
    assert bool(kernel[6])
    for want in (gather, kernel):
        assert int(got[5]) == int(want[5])
        for i in (0, 1, 3, 4):      # keys, counts, mins, maxs
            assert got[i].dtype == torch.int32 and got[i].shape == (cap,)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        np.testing.assert_array_equal(got[2].numpy(), _combine(*want[2]))


@pytest.mark.parametrize("name,cap", CASES)
def test_group_count_and_materialize_match_jax_and_oracle(name, cap):
    keys, _ = _case(name)
    tk = torch.from_numpy(keys)
    assert int(agg.group_count(tk)) == int(jagg.group_count(jnp.asarray(keys)))
    gk, gc, ng = agg.group_materialize(tk, cap)
    jk, jc, jng = jagg.group_materialize(jnp.asarray(keys), cap)
    assert int(ng) == int(jng)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(jc))
    ok, oc = oracle.group_by_count(keys)
    g = int(ng)
    np.testing.assert_array_equal(gk[:g].numpy(), ok)
    np.testing.assert_array_equal(gc[:g].numpy(), oc)


@pytest.mark.parametrize("n,dom,seed", [(1000, 30, 0), (4096, 4096, 1),
                                        (777, 1, 2), (100, 10**9, 3)])
def test_group_by_count_matches_jax_and_oracle(n, dom, seed):
    keys = np.random.default_rng(seed).integers(1, dom + 1, n).astype(
        np.int32)
    gk, gc = agg.group_by_count(keys, device="cpu", pad_multiple=256)
    jk, jc = jagg.group_by_count(keys, pad_multiple=256)
    ok, oc = oracle.group_by_count(keys)
    jok, joc = jax_oracle.group_by_count(keys)
    for want in ((jk, jc), (ok, oc), (jok, joc)):
        np.testing.assert_array_equal(gk, want[0])
        np.testing.assert_array_equal(gc, want[1])
    assert gk.dtype == gc.dtype == np.int32 and gc.sum() == n


@pytest.mark.parametrize("n,dom", [(20_000, 50), (3000, 10**6)])
def test_group_by_agg_matches_jax(n, dom):
    rng = np.random.default_rng(n)
    keys = rng.integers(1, dom, n).astype(np.int32)
    vals = rng.integers(-(2**31) + 1, 2**31 - 1, n, dtype=np.int64).astype(
        np.int32)
    got = agg.group_by_agg(keys, vals, device="cpu")
    want = jagg.group_by_agg(keys, vals)
    assert got[2].dtype == np.int64
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


def test_drivers_on_empty_input():
    """The port returns empty results; the JAX drivers raise here (an
    index into the empty sorted keys; ROADMAP Queue 3)."""
    e = np.empty(0, np.int32)
    gk, gc = agg.group_by_count(e, device="cpu")
    assert gk.shape == gc.shape == (0,)
    out = agg.group_by_agg(e, e, device="cpu")
    assert [c.shape for c in out] == [(0,)] * 5 and out[2].dtype == np.int64
    te = torch.from_numpy(e)
    assert int(agg.group_count(te)) == 0
    gk, gc, sums, mins, maxs, ng = agg.group_agg_materialize(te, te, 16)
    assert int(ng) == 0 and (gk == -1).all() and gk.shape == (16,)
    assert not (gc.any() or sums.any() or mins.any() or maxs.any())
    gk, gc, ng = agg.group_materialize(te, 16)
    assert int(ng) == 0 and (gk == -1).all() and not gc.any()
    with pytest.raises(IndexError):
        jagg.group_by_count(e)
    with pytest.raises(IndexError):
        jagg.group_by_agg(e, e)
