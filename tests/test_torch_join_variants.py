"""The semi, anti and left-outer joins of tpujoin_torch against the JAX
package's (tpujoin.ops.merge_join) on the same numpy inputs (the cases of
tests/test_join_variants.py).

Comparisons: semi and anti ids bitwise (both ascending); the left outer
join's null tail bitwise and its inner pairs as an exact multiset; the
match partition bitwise on the same count state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpujoin_torch
from tpujoin.ops import hash_join as jax_hj
from tpujoin.ops import merge_join as jax_mj
from tpujoin_torch import oracle
from tpujoin_torch.ops import merge_join as mj


def _rand(n, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, n).astype(
        np.int32)


def _pairs(r, s):
    return np.sort(r.astype(np.int64) << 32 | s.astype(np.int64))


CASES = {
    "dups": (_rand(500, 1, 50, 0), _rand(700, 1, 50, 9)),
    "sparse": (_rand(500, 1, 10**6, 1), _rand(700, 1, 10**6, 10)),
    "half": (_rand(300, 1, 40, 2), _rand(400, 1, 80, 3)),
    "all_match": (np.arange(1, 65, dtype=np.int32),
                  _rand(300, 1, 64, 4)),
    "none_match": (np.arange(1, 65, dtype=np.int32),
                   _rand(300, 100, 200, 5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_semi_and_anti_match_jax(case):
    rk, sk = CASES[case]
    semi = tpujoin_torch.semi_join(rk, sk, device="cpu",
                                   row_pad_multiple=256)
    anti = tpujoin_torch.anti_join(rk, sk, device="cpu",
                                   row_pad_multiple=256)
    assert semi.dtype == anti.dtype == np.int32
    np.testing.assert_array_equal(semi, jax_mj.semi_join(rk, sk))
    np.testing.assert_array_equal(anti, jax_mj.anti_join(rk, sk))
    in_build = np.isin(sk, rk)
    np.testing.assert_array_equal(semi, np.nonzero(in_build)[0])
    np.testing.assert_array_equal(anti, np.nonzero(~in_build)[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_left_outer_join_matches_jax(case):
    rk, sk = CASES[case]
    r, s = tpujoin_torch.left_outer_join(rk, sk, device="cpu",
                                         result_pad_multiple=1024)
    jr, js = jax_mj.left_outer_join(rk, sk, result_pad_multiple=1024)
    k, jk = int((r >= 0).sum()), int((jr >= 0).sum())
    assert k == jk and len(r) == len(jr)
    assert (r[:k] >= 0).all() and (r[k:] == -1).all()
    np.testing.assert_array_equal(r[k:], jr[jk:])
    np.testing.assert_array_equal(s[k:], js[jk:])
    np.testing.assert_array_equal(_pairs(r[:k], s[:k]),
                                  _pairs(jr[:jk], js[:jk]))
    np.testing.assert_array_equal(np.unique(s), np.arange(len(sk)))
    assert oracle.check_join(rk, sk, r[:k], s[:k]) == 1


@pytest.mark.parametrize("case", ["dups", "all_match", "none_match"])
def test_match_partition_matches_jax_on_its_state(case):
    """The partition of the probe ids (matched ascending, then unmatched
    ascending) from the JAX count state, bitwise."""
    rk, sk = CASES[case]
    ht = jax_hj.build(jnp.asarray(rk))
    state, _, nonzero = jax_mj.probe_count(ht, jnp.asarray(sk))
    want = np.asarray(jax_mj._match_partition(state))
    port = mj.SortedProbe.from_numpy(np.asarray(state.probe_ids),
                                     np.asarray(state.lo),
                                     np.asarray(state.counts))
    got = mj._match_partition(port, int(nonzero))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_variants_take_and_ignore_other_keywords():
    rk, sk = CASES["half"]
    np.testing.assert_array_equal(
        tpujoin_torch.semi_join(rk, sk, device="cpu", row_pad_multiple=7,
                                result_pad_multiple=3),
        tpujoin_torch.semi_join(rk, sk, device="cpu"))


def test_variants_on_empty_probe():
    rk = np.arange(1, 10, dtype=np.int32)
    e = np.empty(0, np.int32)
    assert tpujoin_torch.semi_join(rk, e, device="cpu").shape == (0,)
    assert tpujoin_torch.anti_join(rk, e, device="cpu").shape == (0,)
    r, s = tpujoin_torch.left_outer_join(rk, e, device="cpu")
    assert r.shape == s.shape == (0,)
