"""tpujoin_torch's verification machinery against the JAX package's: the
window checksums and their host expectation (bitwise), and the native RLE
oracle's verdicts through the port's binding and the JAX one."""
import jax.numpy as jnp
import numpy as np
import torch

from tpujoin import oracle as jax_oracle
from tpujoin.utils import verify as jax_vf
from tpujoin_torch import oracle
from tpujoin_torch.utils import verify as vf

W = vf.VERIFY_WINDOW


def _rle_case(seed=0):
    """An RLE form (src, sid, lo, cnt) whose expansion fills most of two
    windows, and its materialized columns padded with -1 to 2^21 slots."""
    rng = np.random.default_rng(seed)
    n = 5000
    src = rng.permutation(n).astype(np.int32)
    k = 50_000
    cnt = rng.integers(1, 60, k).astype(np.int32)
    lo = rng.integers(0, n - 60, k).astype(np.int32)
    sid = rng.permutation(k).astype(np.int32)
    total = int(cnt.sum())
    assert W < total < 2 * W   # pad slots present in the second window
    r = np.full(2 * W, -1, np.int32)
    s = np.full(2 * W, -1, np.int32)
    r[:total] = src[np.repeat(lo, cnt) + np.arange(total)
                    - np.repeat(np.cumsum(cnt) - cnt, cnt)]
    s[:total] = np.repeat(sid, cnt)
    return src, sid, lo, cnt, total, r, s


def test_window_checksums_match_jax_bitwise():
    *_, total, r, s = _rle_case()
    got = vf.window_checksums(torch.from_numpy(r), torch.from_numpy(s),
                              total, 2)
    want = jax_vf.window_checksums(jnp.asarray(r), jnp.asarray(s),
                                   jnp.asarray(total), 2)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_expected_checksums_match_jax_and_the_columns():
    src, sid, lo, cnt, total, r, s = _rle_case(1)
    got = vf.expected_checksums(src, sid, lo, cnt, total, 2)
    want = jax_vf.expected_checksums(src, sid, lo, cnt, total, 2)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    on_columns = vf.window_checksums(torch.from_numpy(r), torch.from_numpy(s),
                                     total, 2)
    for g, w in zip(on_columns, got[:2]):
        np.testing.assert_array_equal(g, w)


def test_one_flipped_slot_changes_its_window_only():
    *_, total, r, s = _rle_case(2)
    base = vf.window_checksums(torch.from_numpy(r), torch.from_numpy(s),
                               total, 2)
    for slot in (17, W + 5):
        bad = r.copy()
        bad[slot] += 1
        hi, lo = vf.window_checksums(torch.from_numpy(bad),
                                     torch.from_numpy(s), total, 2)
        changed = (hi != base[0]) | (lo != base[1])
        assert changed.tolist() == [slot < W, slot >= W]
    # a slot past the total carries no pair: changing it changes nothing
    bad = s.copy()
    bad[total + 3] = 12345
    hi, lo = vf.window_checksums(torch.from_numpy(r), torch.from_numpy(bad),
                                 total, 2)
    np.testing.assert_array_equal(hi, base[0])
    np.testing.assert_array_equal(lo, base[1])


def test_rle_oracle_verdicts_match_jax_binding():
    rng = np.random.default_rng(3)
    bk = rng.integers(1, 40, 500).astype(np.int32)
    pk = rng.integers(1, 50, 300).astype(np.int32)
    order = np.argsort(bk, kind="stable").astype(np.int32)
    skeys = bk[order]
    lo = np.searchsorted(skeys, pk, "left").astype(np.int32)
    cnt = (np.searchsorted(skeys, pk, "right") - lo).astype(np.int32)
    keep = cnt > 0
    pid = np.nonzero(keep)[0].astype(np.int32)
    lo, cnt = lo[keep], cnt[keep]

    wrong_count = cnt.copy()
    wrong_count[0] += 1
    wrong_id = order.copy()
    wrong_id[lo[0]] = (wrong_id[lo[0]] + 1) % len(bk)
    for case, want in (((order, pid, lo, cnt), 1),
                       ((order, pid, lo, wrong_count), -1),
                       ((wrong_id, pid, lo, cnt), 0)):
        got = oracle.check_join_rle(bk, pk, *case)
        assert got == jax_oracle.check_join_rle(bk, pk, *case) == want
