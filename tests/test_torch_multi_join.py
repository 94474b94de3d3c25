"""The multi-column join and filter pushdown of tpujoin_torch against the
JAX package's (tpujoin.ops.multi_join) on the same numpy inputs (the cases
of tests/test_multi_join.py).

Comparisons: combined_key and one side's pushdown bitwise; joins as exact
pair multisets, against the JAX package and a numpy nested loop.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.core.table import Table as JaxTable
from tpujoin.ops import multi_join as jax_mjn
from tpujoin_torch import oracle
from tpujoin_torch.core.table import Table
from tpujoin_torch.ops import multi_join as mjn

IMAX = np.iinfo(np.int32).max
IMIN = np.iinfo(np.int32).min
_M32 = (1 << 32) - 1


def _both(cols):
    """The same numpy columns as a JAX Table and a port Table (CPU)."""
    return (JaxTable({k: jnp.asarray(v) for k, v in cols.items()}),
            Table.from_numpy(cols, "cpu"))


def _pairs(r, s):
    return np.sort(np.asarray(r).astype(np.int64) << 32
                   | np.asarray(s).astype(np.int64))


def _np_join(r_cols, s_cols, r_keep=None, s_keep=None):
    """O(n m) numpy oracle over composite keys and row masks."""
    eq = np.ones((len(r_cols[0]), len(s_cols[0])), bool)
    for rc, sc in zip(r_cols, s_cols):
        eq &= rc[:, None] == sc[None, :]
    if r_keep is not None:
        eq &= r_keep[:, None]
    if s_keep is not None:
        eq &= s_keep[None, :]
    ri, si = np.nonzero(eq)
    return ri.astype(np.int32), si.astype(np.int32)


def _fmix_inv(h: int) -> int:
    """The key whose murmur3 finalizer (hash32) is ``h``."""
    def unxorshift(x, k):
        y = x
        for _ in range(32 // k + 1):
            y = x ^ (y >> k)
        return y & _M32

    x = unxorshift(h, 16)
    x = x * pow(0xC2B2AE35, -1, 1 << 32) & _M32
    x = unxorshift(x, 13)
    x = x * pow(0x85EBCA6B, -1, 1 << 32) & _M32
    return unxorshift(x, 16)


def _fmix(x: int) -> int:
    x ^= x >> 16
    x = x * 0x85EBCA6B & _M32
    x ^= x >> 13
    x = x * 0xC2B2AE35 & _M32
    return x ^ (x >> 16)


def _tuple_hashing_to(h: int, a: int):
    """(a, b) whose two-column candidate hash, before the fold, is the
    uint32 ``h``: b is solved through the inverse finalizer."""
    ha = _fmix(a & _M32)
    x = _fmix_inv(h)                          # = ha ^ mix
    hb = ((x ^ ha) - 0x9E3779B9 - ((ha << 6) & _M32) - (ha >> 2)) & _M32
    b = _fmix_inv(hb)
    return a, b - (1 << 32) if b >= 1 << 31 else b


def test_fmix_inverse_round_trips():
    for x in (0, 1, 0x7FFFFFFF, 0xDEADBEEF, _M32):
        assert _fmix(_fmix_inv(x)) == x


@pytest.mark.parametrize("on", [["a"], ["a", "b"], ["b", "a"],
                                ["a", "b", "c"], ["c"]])
def test_combined_key_matches_jax(on):
    rng = np.random.default_rng(0)
    n = 5000
    cols = {"a": rng.integers(IMIN, IMAX, n, endpoint=True).astype(np.int32),
            "b": rng.integers(1, 40, n).astype(np.int32),
            "c": rng.choice(np.array([IMAX, IMAX - 1, IMAX - 2, IMIN, 0],
                                     np.int32), n)}
    jt, pt = _both(cols)
    got = mjn.combined_key(pt, on)
    assert got.dtype == torch.int32 and int(got.max()) <= mjn.KEY_MAX
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_mjn.combined_key(jt, on)))


def test_combined_key_order_sensitive():
    _, t = _both({"a": np.array([1, 2], np.int32),
                  "b": np.array([2, 1], np.int32)})
    k_ab = mjn.combined_key(t, ["a", "b"]).numpy()
    k_ba = mjn.combined_key(t, ["b", "a"]).numpy()
    assert k_ab[0] != k_ab[1]
    assert k_ab[0] == k_ba[1] and k_ab[1] == k_ba[0]


@pytest.mark.parametrize("keep", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("pad_key", [mjn.R_PAD_KEY, mjn.S_PAD_KEY])
def test_push_matches_jax(keep, pad_key):
    """One side's pushdown, bitwise: kept ids ascending, their candidate
    keys, sentinel-keyed tail slots, pad ids -1."""
    rng = np.random.default_rng(1)
    n = 3000
    cols = {"a": rng.integers(1, 100, n).astype(np.int32),
            "b": rng.integers(1, 9, n).astype(np.int32),
            "v": rng.random(n).astype(np.float32)}
    jt, pt = _both(cols)
    ji, jh = jax_mjn._push(jt, lambda v: v < keep, "v", np.int32(pad_key),
                           ["a", "b"], 1024)
    pi, ph = mjn._push(pt, lambda v: v < keep, "v", pad_key, ["a", "b"],
                       1024)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    kept = int((cols["v"] < keep).sum())
    assert (pi.numpy()[kept:] == -1).all()
    assert (ph.numpy()[kept:] == pad_key).all()


@pytest.mark.parametrize("seed,dom", [(0, 8), (1, 40)])
def test_two_column_join_matches_jax(seed, dom):
    rng = np.random.default_rng(seed)
    r = {"a": rng.integers(1, dom, 500).astype(np.int32),
         "b": rng.integers(1, dom, 500).astype(np.int32)}
    s = {"a": rng.integers(1, dom, 400).astype(np.int32),
         "b": rng.integers(1, dom, 400).astype(np.int32)}
    got = mjn.hash_join_multi(r, s, ["a", "b"], device="cpu",
                              result_pad_multiple=1024)
    want = jax_mjn.hash_join_multi(*(_both(t)[0] for t in (r, s)),
                                   ["a", "b"], result_pad_multiple=1024)
    np.testing.assert_array_equal(_pairs(*got), _pairs(*want))
    np.testing.assert_array_equal(
        _pairs(*got), _pairs(*_np_join([r["a"], r["b"]], [s["a"], s["b"]])))


def test_single_column_reduces_to_plain_join():
    rng = np.random.default_rng(2)
    rk = rng.integers(1, 30, 300).astype(np.int32)
    sk = rng.integers(1, 30, 300).astype(np.int32)
    r, s = mjn.hash_join_multi({"key": rk}, {"key": sk}, "key",
                               device="cpu", result_pad_multiple=4096)
    assert oracle.check_join(rk, sk, r, s) == 1


def test_collision_pairs_are_filtered():
    r = {"a": np.full(64, 5, np.int32), "b": np.arange(64, dtype=np.int32)}
    got_r, got_s = mjn.hash_join_multi(r, dict(r), ["a", "b"], device="cpu",
                                       result_pad_multiple=256)
    assert len(got_r) == 64
    np.testing.assert_array_equal(np.sort(got_r), np.arange(64))
    np.testing.assert_array_equal(got_r, got_s)


def test_pushdown_matches_jax_with_ids_of_the_original_tables():
    rng = np.random.default_rng(3)
    rk = rng.integers(1, 20, 400).astype(np.int32)
    sk = rng.integers(1, 20, 300).astype(np.int32)
    rv = rng.uniform(0, 160, 400).astype(np.float32)
    sv = rng.uniform(0, 160, 300).astype(np.float32)
    r, s = {"key": rk, "val": rv}, {"key": sk, "val": sv}
    kw = {"r_pred": lambda v: v < 80.0, "r_pred_col": "val",
          "s_pred": lambda v: v < 40.0, "s_pred_col": "val",
          "result_pad_multiple": 1024}
    got = mjn.join_with_pushdown(r, s, "key", device="cpu", **kw)
    want = jax_mjn.join_with_pushdown(_both(r)[0], _both(s)[0], "key", **kw)
    np.testing.assert_array_equal(_pairs(*got), _pairs(*want))
    np.testing.assert_array_equal(
        _pairs(*got), _pairs(*_np_join([rk], [sk], rv < 80.0, sv < 40.0)))


def test_pushdown_empty_side():
    r = {"key": np.array([1, 2, 3], np.int32),
         "val": np.array([100.0, 100.0, 100.0], np.float32)}
    s = {"key": np.array([1, 2], np.int32),
         "val": np.array([1.0, 1.0], np.float32)}
    got_r, got_s = mjn.join_with_pushdown(
        r, s, "key", device="cpu", r_pred=lambda v: v < 80.0,
        r_pred_col="val")
    assert len(got_r) == len(got_s) == 0
    out_r, out_s, total = mjn.join_with_pushdown(
        r, s, "key", device="cpu", r_pred=lambda v: v < 80.0,
        r_pred_col="val", return_numpy=False)
    assert total == 0 and out_r.shape == (0,)


@pytest.mark.parametrize("on", [["a"], ["a", "b"]])
def test_pushdown_with_keys_folded_at_the_sentinels(on):
    """Real keys whose candidate key lands on or next to the pad
    sentinels: single-column keys IMAX, IMAX - 1, IMAX - 2, and tuples
    whose hash is 0x7FFFFFFD, 0x7FFFFFFE or 0x7FFFFFFF before the fold. All
    fold onto 0x7FFFFFFD; pad slots (0x7FFFFFFF build side, 0x7FFFFFFE
    probe side) match nothing, and the folded collisions are filtered."""
    if on == ["a"]:
        top = [(IMAX, 0), (IMAX - 1, 0), (IMAX - 2, 0), (5, 0)]
    else:
        top = [_tuple_hashing_to(h, a) for h, a in
               ((0x7FFFFFFF, 3), (0x7FFFFFFE, 4), (0x7FFFFFFD, 5),
                (0x7FFFFFFF, 6), (0x1234, 7))]
    rng = np.random.default_rng(len(on))

    def side(n):
        pick = rng.integers(0, len(top), n)
        return {"a": np.array([top[i][0] for i in pick], np.int32),
                "b": np.array([top[i][1] for i in pick], np.int32),
                "v": rng.random(n).astype(np.float32)}

    r, s = side(300), side(200)
    hk = mjn.combined_key(Table.from_numpy(r, "cpu"), on).numpy()
    assert (hk == mjn.KEY_MAX).sum() >= len(r) // 2
    kw = {"r_pred": lambda v: v < 0.6, "r_pred_col": "v",
          "s_pred": lambda v: v < 0.7, "s_pred_col": "v",
          "result_pad_multiple": 256}
    got = mjn.join_with_pushdown(r, s, on, device="cpu", **kw)
    want = _np_join([r[c] for c in on], [s[c] for c in on], r["v"] < 0.6,
                    s["v"] < 0.7)
    np.testing.assert_array_equal(_pairs(*got), _pairs(*want))
    jax_got = jax_mjn.join_with_pushdown(_both(r)[0], _both(s)[0], on, **kw)
    np.testing.assert_array_equal(_pairs(*got), _pairs(*jax_got))
    plain = mjn.hash_join_multi(r, s, on, device="cpu",
                                result_pad_multiple=256)
    np.testing.assert_array_equal(
        _pairs(*plain), _pairs(*_np_join([r[c] for c in on],
                                         [s[c] for c in on])))
