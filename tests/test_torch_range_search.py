"""The equal-range search's plain forms (tpujoin_torch/kernels/
range_search.py) on the CPU: the directory's bucket bounds, then the
search inside a bucket, against two torch.searchsorted. The kernels' cases
on the card are in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from tpujoin_torch.kernels import range_search as rs
from tpujoin_torch.ops import hash_join

from range_cases import CASES, range_case, two_searchsorted


@pytest.mark.parametrize("case", CASES)
def test_directory_holds_each_bucket_start_lower_bound(case):
    """dir[b] is the lower bound of kmin + (b << shift) over the whole
    column, dir[2^p] = n, every key lies in a bucket, and params hold
    (kmin, shift, the largest bucket)."""
    keys, _ = range_case(case)
    n, p = keys.shape[0], rs.bucket_bits(keys.shape[0])
    dir_, params = rs.directory_plain(keys)
    kmin, shift, largest = (int(v) for v in params)
    if case in ("narrow", "dup8", "one_key"):
        assert shift == 0
    assert dir_.dtype == torch.int32 and dir_.shape == ((1 << p) + 1,)
    assert params.dtype == torch.int64
    k = keys.numpy().astype(np.int64)
    if n:
        assert kmin == k[0]
        assert (int(k[-1]) - kmin) >> shift < 1 << p
        assert shift == 0 or (int(k[-1]) - kmin) >> (shift - 1) >= 1 << p
    starts = kmin + (np.arange((1 << p) + 1, dtype=np.int64) << shift)
    np.testing.assert_array_equal(dir_.numpy(), np.searchsorted(k, starts))
    assert int(dir_[-1]) == n
    assert largest == int(np.diff(dir_.numpy()).max())


@pytest.mark.parametrize("case", CASES)
def test_search_in_buckets_is_two_searchsorted(case):
    """The bucket bounds and the search inside them give lo and cnt
    bitwise equal to two torch.searchsorted, for matched, unmatched and
    out-of-range probe keys, in probe order."""
    keys, probe = range_case(case)
    got = rs.search_count_plain(keys, probe, *rs.directory_plain(keys))
    want = two_searchsorted(keys, probe)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
    assert torch.equal(rs.equal_range(keys, probe)[1], want[1])


@pytest.mark.parametrize("n", [0, 1, 63, 64, 1000, 10**7, 10**8,
                               2**31 - 1])
def test_bucket_bits_gives_32_to_64_keys_a_bucket(n):
    p = rs.bucket_bits(n)
    assert p >= 0
    if n >= 64:
        assert 32 <= n / (1 << p) < 64
    else:
        assert p == 0
    if n == 10**8:
        assert p == 21


def test_probe_count_on_the_cpu_stays_two_searchsorted(monkeypatch):
    """v1's probe_count on CPU tensors calls torch.searchsorted, left and
    right, and no directory."""
    keys, probe = range_case("uniform")
    ht = hash_join.HashJoinTable(keys, torch.arange(keys.shape[0],
                                                    dtype=torch.int32))
    calls = []
    real = torch.searchsorted

    def spy(*args, **kwargs):
        calls.append(kwargs.get("right", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "searchsorted", spy)
    monkeypatch.setattr(rs, "directory", None)
    lo, counts = hash_join.probe_count(ht, probe)
    assert calls == [False, True]
    monkeypatch.undo()
    for g, w in zip((lo, counts), two_searchsorted(keys, probe), strict=True):
        assert torch.equal(g, w)
