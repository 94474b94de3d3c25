"""The port's distributed shuffle join against the JAX package's, on an
8-shard in-process CPU mesh against JAX's 8 emulated CPU devices
(tests/conftest.py), with Pallas in interpret mode: the counterparts of
tests/test_dist.py.

Everything compared is an integer, so every comparison is exact. Keys,
splitters, segment maxima and per-shard totals are compared bitwise; the
pairs of each shard as a multiset (the JAX sorts are unstable, K1 is
stable, so within a key the ids may come in another order); whole results
against the native oracle.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec

import tpujoin_torch
from tpujoin.parallel import shuffle_join as jsj
from tpujoin.parallel.mesh import ROW_AXIS
from tpujoin.parallel.mesh import make_mesh as jax_mesh
from tpujoin_torch import oracle
from tpujoin_torch.dryrun import dryrun_multichip
from tpujoin_torch.parallel import shuffle_join as tsj
from tpujoin_torch.parallel.mesh import make_mesh


def _rand(n, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi + 1, n).astype(
        np.int32)


def _padded(keys, mult):
    return jsj._pad_sharded(keys, np.arange(len(keys), dtype=np.int32), mult)


def _jax_args(mesh, arrays):
    shard = NamedSharding(mesh, PartitionSpec(ROW_AXIS))
    return [jax.device_put(x, shard) for x in arrays]


def _pair_sets(r, s, totals, blocks):
    """Each block's first totals[b] pairs, sorted: a multiset a block."""
    r, s = np.asarray(r).reshape(blocks, -1), np.asarray(s).reshape(blocks,
                                                                     -1)
    return [sorted(zip(r[b, :t].tolist(), s[b, :t].tolist()))
            for b, t in enumerate(np.asarray(totals).reshape(-1))]


@pytest.fixture(scope="module")
def meshes():
    return {p: (jax_mesh(p), make_mesh(p, device="cpu")) for p in (4, 8)}


CASES = [(4096, 4096, 500, 0, 8),
         (1000, 3000, 100, 1, 8),
         (4097, 999, 50, 2, 8),     # sizes the mesh does not divide
         (512, 512, 64, 4, 4)]      # a 4-of-8 mesh


@pytest.mark.parametrize("n,m,dom,seed,p", CASES)
def test_plain_program_matches_jax(meshes, n, m, dom, seed, p):
    """The auto-caps pre-pass (splitters and segment maxima) and the step
    at those caps (per-shard totals, telemetry, per-shard pairs) bitwise
    against JAX; the driver's pairs against the oracle."""
    jm, tm = meshes[p]
    rk, sk = _rand(n, 1, dom, seed), _rand(m, 1, dom, seed + 7)
    cols = [*_padded(rk, p), *_padded(sk, p)]
    j_stats = jsj.make_splitter_stats_fn(jm)(*_jax_args(jm, cols))
    t_stats = tsj.make_splitter_stats_fn(tm)(*[tm.put_rows(c)
                                                for c in cols])
    np.testing.assert_array_equal(t_stats[4].numpy(), np.asarray(j_stats[4]))
    np.testing.assert_array_equal(t_stats[5].numpy(), np.asarray(j_stats[5]))
    for j, t in zip(j_stats[:4:2], t_stats[:4:2]):    # sorted keys
        np.testing.assert_array_equal(torch.cat(t).numpy(), np.asarray(j))

    cap_r, cap_s = (int(v) + 64 for v in t_stats[5])
    cap = oracle.join_count(rk, sk) + 64
    j_out = jsj.make_shuffle_join_presorted_fn(jm, cap_r, cap_s, cap)(
        *j_stats[:5])
    t_out = tsj.make_shuffle_join_presorted_fn(tm, cap_r, cap_s, cap)(
        *t_stats[:5])
    totals = torch.cat(t_out[2]).numpy()
    np.testing.assert_array_equal(totals, np.asarray(j_out[2]))
    np.testing.assert_array_equal(t_out[3].numpy(), np.asarray(j_out[3])[:3])
    assert (_pair_sets(torch.cat(t_out[0]), torch.cat(t_out[1]), totals, p)
            == _pair_sets(j_out[0], j_out[1], j_out[2], p))

    r_ids, s_ids = tpujoin_torch.distributed_hash_join(
        rk, sk, mesh=tm, expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


def test_unpresorted_step_equals_the_presorted_one(meshes):
    jm, tm = meshes[8]
    rk, sk = _rand(1000, 1, 100, 1), _rand(3000, 1, 100, 8)
    cols = [tm.put_rows(c) for c in (*_padded(rk, 8), *_padded(sk, 8))]
    stats = tsj.make_splitter_stats_fn(tm)(*cols)
    a = tsj.make_shuffle_join_fn(tm, 1024, 1024, 40_000)(*cols)
    b = tsj.make_shuffle_join_presorted_fn(tm, 1024, 1024, 40_000)(
        *stats[:5])
    for x, y in zip(a[:3], b[:3]):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert torch.equal(a[3], b[3])


def test_empty_result(meshes):
    rk = np.arange(1, 1001, dtype=np.int32)
    sk = np.arange(100_000, 101_000, dtype=np.int32)
    r_ids, s_ids = tpujoin_torch.distributed_hash_join(
        rk, sk, mesh=meshes[8][1], expected_matches=0)
    assert len(r_ids) == 0 and r_ids.dtype == np.int32
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


def test_skewed_keys_overflow_retry(meshes, monkeypatch):
    """One key on 30% of the rows overflows the result estimate of the
    shard that holds it; the driver retries to the exact result."""
    rng = np.random.default_rng(3)
    rk = rng.integers(1, 200, 4000).astype(np.int32)
    sk = rng.integers(1, 200, 4000).astype(np.int32)
    rk[:1200] = 42
    sk[:1200] = 42
    steps = []
    make = tsj.make_shuffle_join_presorted_fn
    monkeypatch.setattr(tsj, "make_shuffle_join_presorted_fn",
                        lambda *a: steps.append(a[1:]) or make(*a))
    r_ids, s_ids = tpujoin_torch.distributed_hash_join(
        rk, sk, mesh=meshes[8][1], slack=1.1,
        expected_matches=oracle.join_count(rk, sk))
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1
    assert len(steps) == 2 and steps[1][2] > steps[0][2]


def _rle_pairs(shard):
    """A shard's runs expanded, as a sorted pair list."""
    keep = shard["cnt"] > 0
    lo, cnt = shard["lo"][keep], shard["cnt"][keep]
    j = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    r = shard["build_ids"][np.repeat(lo, cnt) + j]
    return sorted(zip(r.tolist(), np.repeat(shard["probe_ids"][keep],
                                            cnt).tolist()))


def _runs(shard):
    """A shard's (probe id, count) rows, sorted."""
    return sorted(zip(shard["probe_ids"].tolist(), shard["cnt"].tolist()))


@pytest.mark.parametrize("dom,seed,expand", [(200, 21, True),
                                             (8, 23, False)])
def test_rle_program_matches_jax(meshes, dom, seed, expand):
    """The exact global pair count, each shard's (probe id, count) rows
    and build ids, and (at the low duplication) each shard's expanded
    pairs, against JAX's; dom 8 is the high duplication (~2M pairs from
    4096 rows a side)."""
    jm, tm = meshes[8]
    rk, sk = _rand(4096, 1, dom, seed), _rand(4096, 1, dom, seed + 1)
    j_shards, j_total = jsj.distributed_hash_join_rle(rk, sk, mesh=jm)
    t_shards, t_total = tsj.distributed_hash_join_rle(rk, sk, mesh=tm)
    assert t_total == j_total == oracle.join_count(rk, sk)
    assert isinstance(t_total, int) and len(t_shards) == 8
    for j, t in zip(j_shards, t_shards):
        assert _runs(t) == _runs(j)
        np.testing.assert_array_equal(np.sort(t["build_ids"]),
                                      np.sort(j["build_ids"]))
        if expand:
            assert _rle_pairs(t) == _rle_pairs(j)
    if expand:
        pairs = np.array([p for t in t_shards for p in _rle_pairs(t)],
                         np.int32).reshape(-1, 2)
        assert oracle.check_join(rk, sk, pairs[:, 0], pairs[:, 1]) == 1


def test_semi_anti_match_jax_and_single_card(meshes):
    jm, tm = meshes[8]
    rk = _rand(2048, 1, 400, 31)
    sk = _rand(3001, 1, 600, 32)     # some probe keys unmatched
    semi = tsj.distributed_semi_join(rk, sk, mesh=tm)
    anti = tsj.distributed_anti_join(rk, sk, mesh=tm)
    np.testing.assert_array_equal(semi,
                                  jsj.distributed_semi_join(rk, sk, mesh=jm))
    np.testing.assert_array_equal(anti,
                                  jsj.distributed_anti_join(rk, sk, mesh=jm))
    np.testing.assert_array_equal(
        semi, tpujoin_torch.semi_join(rk, sk, device="cpu"))
    np.testing.assert_array_equal(
        anti, tpujoin_torch.anti_join(rk, sk, device="cpu"))
    assert len(semi) + len(anti) == len(sk)


@pytest.mark.parametrize("p", [1, 8])
def test_dryrun_multichip(p):
    dryrun_multichip(p, device="cpu")


def test_mesh_collectives_in_process():
    mesh = make_mesh(3, device="cpu")
    bufs = [torch.arange(6, dtype=torch.int32).view(3, 2) + 10 * d
            for d in range(3)]
    out = mesh.all_to_all(bufs)
    for d in range(3):
        for p in range(3):
            assert torch.equal(out[d][p], bufs[p][d])
    assert [o.tolist() for o in mesh.all_to_all(bufs, async_op=True).wait()
            ] == [o.tolist() for o in out]
    g = mesh.all_gather([torch.tensor([d, -d]) for d in range(3)])
    assert len(g) == 3 and g[2].tolist() == [0, 0, 1, -1, 2, -2]
    xs = [torch.tensor([d, 5 - d]) for d in range(3)]
    assert mesh.all_reduce(xs, "sum").tolist() == [3, 12]
    assert mesh.all_reduce(xs, "max").tolist() == [2, 5]
    with pytest.raises(ValueError):
        mesh.all_reduce(xs, "min")
    assert [x.tolist() for x in mesh.put_rows(np.arange(6))] == [
        [0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError):
        mesh.put_rows(np.arange(7))


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the refusal without a CUDA device")
def test_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)
    assert make_mesh(4, device="cpu").device.type == "cpu"
