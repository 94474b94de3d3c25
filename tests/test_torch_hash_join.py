"""The v1 (searchsorted) engine of tpujoin_torch against the JAX package's
tpujoin.ops.hash_join on the same numpy inputs (the cases of
tests/test_hash_join.py).

Comparisons: the count phase bitwise; probe_materialize bitwise when both
are given the same HashJoinTable (the JAX build sorts unstably, so its ids
inside an equal-key run may differ from K1's: a build is compared keys
bitwise and ids per run as a multiset); whole joins as exact pair
multisets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpujoin_torch
from tpujoin.ops import hash_join as jax_hj
from tpujoin_torch import oracle
from tpujoin_torch.kernels import forward_fill
from tpujoin_torch.ops import hash_join as hj


def _rand(n, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, n).astype(
        np.int32)


def _pairs(r, s):
    return np.sort(np.asarray(r).astype(np.int64) << 32
                   | np.asarray(s).astype(np.int64))


def _runs(keys, ids):
    order = np.lexsort((ids, keys))
    return np.stack([keys[order], ids[order]])


def _same_table(bk):
    """The JAX build of ``bk`` and the port's table holding its state."""
    ht = jax_hj.build(jnp.asarray(bk))
    return ht, hj.HashJoinTable.from_numpy(np.asarray(ht.sorted_keys),
                                           np.asarray(ht.sorted_ids))


CASES = [(100, 100, 20, 0),        # heavy duplication
         (1000, 500, 1000, 1),     # ~1 match a row
         (513, 1023, 7, 2),        # ragged widths, tiny domain
         (2048, 2048, 10**9, 3)]   # almost no matches


@pytest.mark.parametrize("n,m,dom,seed", CASES)
def test_build_and_count_match_jax(n, m, dom, seed):
    bk, pk = _rand(n, 1, dom, seed), _rand(m, 1, dom, seed + 100)
    jht, port_ht = _same_table(bk)
    own = hj.build(torch.from_numpy(bk))
    np.testing.assert_array_equal(own.sorted_keys.numpy(),
                                  np.asarray(jht.sorted_keys))
    np.testing.assert_array_equal(
        _runs(own.sorted_keys.numpy(), own.sorted_ids.numpy()),
        _runs(np.asarray(jht.sorted_keys), np.asarray(jht.sorted_ids)))
    jlo, jcnt = jax_hj.probe_count(jht, jnp.asarray(pk))
    lo, cnt = hj.probe_count(port_ht, torch.from_numpy(pk))
    assert lo.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


@pytest.mark.parametrize("n,m,dom,seed", CASES + [(4000, 4000, 300, 5),
                                                  (64, 32, 1, 6)])
@pytest.mark.parametrize("cap_of", ["sparse", "exact", "ragged",
                                    "undersized"])
@pytest.mark.parametrize("probe_base", [0, 1000])
def test_probe_materialize_matches_jax(n, m, dom, seed, cap_of, probe_base):
    """Both regimes on the same table, bitwise: capacity below the probe
    rows (searchsorted of the slots) and from them on (fill_forward of the
    row markers), a capacity that is no multiple of the fill's 8192-slot
    tile, and one below the total (fits False, as in JAX)."""
    bk, pk = _rand(n, 1, dom, seed), _rand(m, 1, dom, seed + 100)
    jht, port_ht = _same_table(bk)
    jlo, jcnt = jax_hj.probe_count(jht, jnp.asarray(pk))
    lo, cnt = hj.probe_count(port_ht, torch.from_numpy(pk))
    total = int(cnt.sum())
    cap = {"sparse": max(min(total, m - 1), 1),
           "exact": max(total, 1),
           "ragged": max(total, m) + 8192 * 3 + 5,
           "undersized": max(total // 2, 1)}[cap_of]
    jr, js, jtot, jfits = jax_hj.probe_materialize(jht, jlo, jcnt, cap,
                                                   probe_base=probe_base)
    r, s, tot, fits = hj.probe_materialize(port_ht, lo, cnt, cap,
                                           probe_base=probe_base)
    assert r.dtype == s.dtype == torch.int32 and r.shape == (cap,)
    assert int(tot) == int(jtot) == total
    assert bool(fits) == bool(jfits) == (total <= cap)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_dense_materialize_fills_row_markers():
    """From capacity >= m the rows come from fill_forward over the
    markers: each matched row's index at its offset."""
    cnt = torch.tensor([0, 2, 0, 0, 3, 1], dtype=torch.int32)
    offsets = torch.cumsum(cnt, 0, dtype=torch.int64) - cnt
    mark = hj.row_markers(offsets, cnt, 6).reshape(-1)
    assert mark.shape[0] == hj.FILL_STEP
    assert mark[:6].tolist() == [1, -1, 4, -1, -1, 5]
    assert (mark[6:] == -1).all()
    filled = forward_fill.fill_forward(mark.view(-1, 128), hj.FILL_STEP)
    assert filled.reshape(-1)[:6].tolist() == [1, 1, 4, 4, 4, 5]


@pytest.mark.parametrize("n,m,dom,seed", CASES)
def test_hash_join_matches_jax(n, m, dom, seed):
    rk, sk = _rand(n, 1, dom, seed), _rand(m, 1, dom, seed + 100)
    jr, js = jax_hj.hash_join(rk, sk, result_pad_multiple=256)
    r, s = tpujoin_torch.hash_join(rk, sk, device="cpu",
                                   result_pad_multiple=256)
    assert r.dtype == s.dtype == np.int32
    np.testing.assert_array_equal(_pairs(r, s), _pairs(jr, js))
    assert oracle.check_join(rk, sk, r, s) == 1
    if len(r):
        np.testing.assert_array_equal(rk[r], sk[s])


def test_chunked_probe_matches_unchunked_and_jax():
    """Chunks of 700 rows, the last one at its own length."""
    rk, sk = _rand(4000, 1, 300, 5), _rand(4000, 1, 300, 6)
    a = tpujoin_torch.hash_join(rk, sk, device="cpu",
                                result_pad_multiple=512)
    b = tpujoin_torch.hash_join(rk, sk, device="cpu", probe_chunk_rows=700,
                                result_pad_multiple=512)
    j = jax_hj.hash_join(rk, sk, probe_chunk_rows=700,
                         result_pad_multiple=512)
    np.testing.assert_array_equal(_pairs(*a), _pairs(*b))
    np.testing.assert_array_equal(_pairs(*b), _pairs(*j))
    assert oracle.check_join(rk, sk, *b) == 1


def test_empty_result():
    rk = np.arange(1, 101, dtype=np.int32)
    sk = np.arange(1001, 1101, dtype=np.int32)
    r, s = tpujoin_torch.hash_join(rk, sk, device="cpu")
    jr, js = jax_hj.hash_join(rk, sk)
    assert len(r) == len(s) == len(jr) == 0
    e = np.empty(0, np.int32)
    r, s = tpujoin_torch.hash_join(e, e, device="cpu")
    assert r.shape == s.shape == (0,)


def test_all_equal_keys():
    """Every row matches every row."""
    rk, sk = np.full(64, 7, np.int32), np.full(32, 7, np.int32)
    r, s = tpujoin_torch.hash_join(rk, sk, device="cpu",
                                   result_pad_multiple=4096)
    jr, js = jax_hj.hash_join(rk, sk, result_pad_multiple=4096)
    assert len(r) == 64 * 32
    np.testing.assert_array_equal(_pairs(r, s), _pairs(jr, js))
    assert oracle.check_join(rk, sk, r, s, nested=True) == 1


def test_hash_join_returns_tensors_on_request():
    rk, sk = _rand(300, 1, 30, 7), _rand(200, 1, 30, 8)
    r, s = tpujoin_torch.hash_join(torch.from_numpy(rk),
                                   torch.from_numpy(sk),
                                   return_numpy=False)
    assert isinstance(r, torch.Tensor) and r.device.type == "cpu"
    assert oracle.check_join(rk, sk, r, s) == 1


def test_hash_join_rle_matches_jax():
    rk, sk = _rand(1000, 1, 100, 10), _rand(777, 1, 100, 11)
    got = hj.hash_join_rle(rk, sk, device="cpu")
    want = jax_hj.hash_join_rle(rk, sk)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(_runs(np.sort(rk), got[3]),
                                  _runs(np.sort(rk), want[3]))
    assert oracle.check_join_rle(rk, sk, *got[3:], *got[:3]) == 1
    expected = np.asarray([(rk == k).sum() for k in sk])
    np.testing.assert_array_equal(got[2], expected)


def test_hash_join_device_matches_jax():
    rk, sk = _rand(256, 1, 50, 8), _rand(256, 1, 50, 9)
    r, s, total, fits = hj.hash_join_device(rk, sk, 4096, device="cpu")
    jr, js, jtotal, jfits = jax_hj.hash_join_device(
        jnp.asarray(rk), jnp.asarray(sk), capacity=4096)
    assert bool(fits) and bool(jfits) and int(total) == int(jtotal)
    total = int(total)
    assert total == oracle.join_count(rk, sk)
    assert (r[total:] == -1).all() and (s[total:] == -1).all()
    np.testing.assert_array_equal(_pairs(r[:total], s[:total]),
                                  _pairs(np.asarray(jr[:total]),
                                         np.asarray(js[:total])))


def test_empty_build_side_gives_pad_slots():
    """With no build row, every slot is -1. The JAX probe_materialize
    raises IndexError here (a take from an empty axis); its hash_join
    never calls it on an empty result."""
    pk = np.array([1, 2, 3], np.int32)
    e = np.empty(0, np.int32)
    r, s, total, fits = hj.hash_join_device(e, pk, 16, device="cpu")
    assert int(total) == 0 and bool(fits)
    assert (r == -1).all() and (s == -1).all() and r.shape == (16,)
    with pytest.raises(IndexError):
        jax_hj.hash_join_device(jnp.asarray(e), jnp.asarray(pk), 16)


def test_capacity_past_int32_is_refused():
    port_ht = hj.HashJoinTable.from_numpy(np.array([1], np.int32),
                                          np.array([0], np.int32))
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        hj.probe_materialize(port_ht, one - 1, one, 1 << 31)
