"""The port's skew-aware distributed join against the JAX package's, on an
8-shard in-process CPU mesh against JAX's 8 emulated CPU devices
(tests/conftest.py): the counterparts of tests/test_skew.py.

The step at fixed capacities is compared exactly: per-shard totals and
telemetry (segment maxima, replica counts) bitwise, each shard's pairs as
a multiset. The driver's pairs go to the native oracle.
"""
import numpy as np
import pytest
import torch

import jax

from tpujoin.core import datagen
from tpujoin.parallel import skew as jskew
from tpujoin.parallel.mesh import make_mesh as jax_mesh
from tpujoin_torch import oracle
from tpujoin_torch.parallel import skew as tskew
from tpujoin_torch.parallel.mesh import make_mesh
from tpujoin_torch.parallel.shuffle_join import distributed_hash_join
from test_torch_dist import _jax_args, _padded, _pair_sets


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh(8), make_mesh(8, device="cpu")


def _uniform(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 400, 4096).astype(np.int32),
            rng.integers(1, 400, 4096).astype(np.int32))


def _dominant(seed):
    # 40% of both sides share one key (test_skew.py's at a quarter of its
    # rows: interpret mode's time grows with the pairs)
    rng = np.random.default_rng(seed)
    rk = rng.integers(1, 1000, 1000).astype(np.int32)
    sk = rng.integers(1, 1000, 1000).astype(np.int32)
    rk[:400] = 77
    sk[:400] = 77
    return rk, sk


def _zipf(seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(datagen.zipf_keys(k1, 2048, 1, 2000, s=1.0)),
            np.asarray(datagen.zipf_keys(k2, 2048, 1, 2000, s=1.0)))


def _half_one_key(seed):
    # half the probe side on one key (test_skew.py's at half its rows)
    rng = np.random.default_rng(seed)
    rk = rng.integers(1, 1000, 4000).astype(np.int32)
    sk = rng.integers(1, 1000, 4000).astype(np.int32)
    sk[:2000] = 55
    return rk, sk


def _one_side(seed):
    # heavy in R, light in S: S replicated, R sprayed
    rng = np.random.default_rng(seed)
    rk = rng.integers(1, 500, 4000).astype(np.int32)
    rk[:2000] = 99
    return rk, rng.integers(1, 500, 4000).astype(np.int32)


# Every case padded to ROWS a side (pads carry id -1), at one set of
# capacities, so that JAX compiles its step once for all of them. CAP is
# above every case's largest shard total (zipf's: 37,540): interpret
# mode pays for every slot.
ROWS = 4096
CAP = 40_000


@pytest.mark.parametrize("make,seed", [(_uniform, 0), (_dominant, 1),
                                       (_zipf, 0), (_one_side, 2),
                                       (_half_one_key, 3)],
                         ids=["uniform", "dominant", "zipf", "one_side",
                              "half_one_key"])
def test_skew_program_matches_jax(meshes, make, seed):
    """The step at capacities that hold every row: per-shard totals and
    the telemetry bitwise against JAX's, each shard's pairs as a
    multiset; the driver against the oracle."""
    jm, tm = meshes
    rk, sk = make(seed)
    cols = [*_padded(rk, ROWS), *_padded(sk, ROWS)]
    args = (ROWS, ROWS, ROWS, ROWS, CAP)
    t_out = tskew.make_skew_join_fn(tm, *args, top_h=16)(
        *[tm.put_rows(c) for c in cols])
    j_out = jskew.make_skew_join_fn(jm, *args, top_h=16)(
        *_jax_args(jm, cols))
    assert int(t_out[3][2]) <= CAP
    totals = torch.cat(t_out[2]).numpy()
    np.testing.assert_array_equal(totals, np.asarray(j_out[2]))
    np.testing.assert_array_equal(t_out[3].numpy(), np.asarray(j_out[3]))
    assert (_pair_sets(torch.cat(t_out[0]), torch.cat(t_out[1]), totals, 8)
            == _pair_sets(j_out[0], j_out[1], j_out[2], 8))

    r_ids, s_ids = tskew.distributed_hash_join_skew(
        rk, sk, mesh=tm, expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


def test_skew_balances_send_buffers(meshes):
    """Half the probe side on one key: the plain range partition sends it
    all to one shard, the skew split sprays it; both are exact."""
    tm = meshes[1]
    rk, sk = _half_one_key(3)
    exp = oracle.join_count(rk, sk)
    r_ids, s_ids = tskew.distributed_hash_join_skew(
        rk, sk, mesh=tm, slack=1.5, expected_matches=exp)
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1
    r2, s2 = distributed_hash_join(rk, sk, mesh=tm, expected_matches=exp)
    assert oracle.check_join(rk, sk, r2, s2) == 1
    plain = tskew.shard_rows(rk, sk, mesh=tm)
    split = tskew.shard_rows(rk, sk, mesh=tm, skew=True)
    assert plain.sum() == len(rk) + len(sk) and plain.max() >= 2000
    # every row once, the replicated heavy build rows once a shard
    assert split.max() < plain.max() / 2
    assert split.sum() == len(rk) + len(sk) + 7 * int((rk == 55).sum())


def test_distributed_hash_join_takes_the_skew_path(meshes, monkeypatch):
    calls = []
    real = tskew.distributed_hash_join_skew
    monkeypatch.setattr(tskew, "distributed_hash_join_skew",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    rk, sk = _dominant(1)
    r_ids, s_ids = distributed_hash_join(rk, sk, mesh=meshes[1], skew=True)
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1
    assert len(calls) == 1 and calls[0]["slack"] == 2.0


@pytest.mark.parametrize("h", [2, 6])
def test_top_keys_match_jax_on_ties(h):
    """Equal counts go to the smaller key, as jax.lax.top_k gives them."""
    keys = np.array([5, 3, 3, 9, 9, 1, 7, 7], np.int32)
    ids = np.arange(8, dtype=np.int32)
    ids[0] = -1                      # a driver pad: not counted
    want = np.asarray(jskew._local_top_keys(keys, ids, h, 0x7FFFFFFF))
    got = tskew._local_top_keys(torch.from_numpy(keys),
                                torch.from_numpy(ids), h, 0x7FFFFFFF)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist()[:3] == [3, 7, 9][:h]
