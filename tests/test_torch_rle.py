"""The high-selectivity slice: tpujoin_torch's RLE result, group heads,
materialize planner, merge_join and dense bench against the JAX package's,
on the same numpy inputs.

JAX's build and count state carries over through
``HashJoinTable.from_numpy`` and ``SortedProbe.from_numpy``; outputs
computed from one state must then match bitwise, except where the JAX
side compacts with its unstable sort (pairs are then compared as an exact
multiset). Two joins: ~64 matches per probe row (the fill path) and ~16
(the JAX planner's runs path, which the port takes as expand).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpujoin
import tpujoin_torch
from tpujoin.ops import hash_join as jax_hj
from tpujoin.ops import merge_join as jax_mj
from tpujoin_torch import bench, oracle
from tpujoin_torch.core.config import JoinConfig
from tpujoin_torch.ops import merge_join as mj
from tpujoin_torch.ops.hash_join import HashJoinTable
from tpujoin_torch.utils.shapes import round_up

PAD = 1 << 12   # result_pad_multiple of the joins below
# (rows of each side, key domain): ~64 and ~16 matches per probe row
JOINS = {"fill": (2048, 32), "runs": (4096, 256)}


def _keys(n, key_max, seed):
    return np.random.default_rng(seed).integers(1, key_max + 1, n).astype(
        np.int32)


def _pairs(r, s):
    return np.sort(np.asarray(r).astype(np.int64) << 32
                   | np.asarray(s).astype(np.int64))


def _port_state(ht, state):
    return (HashJoinTable.from_numpy(np.asarray(ht.sorted_keys),
                                     np.asarray(ht.sorted_ids)),
            mj.SortedProbe.from_numpy(np.asarray(state.probe_ids),
                                      np.asarray(state.lo),
                                      np.asarray(state.counts)))


def _jax_join(path, probe_key_max=None):
    """Keys of the ``path`` join and the JAX build and count state on them,
    with the capacities merge_join gives that chunk."""
    rows, key_max = JOINS[path]
    bk = _keys(rows, key_max, 1)
    pk = _keys(rows, probe_key_max or key_max, 2)
    ht = jax_hj.build(jnp.asarray(bk))
    state, total, nonzero = jax_mj.probe_count(ht, jnp.asarray(pk))
    total, nonzero = int(total), int(nonzero)
    caps = (round_up(nonzero, max(PAD // 8, 1024)), round_up(total, PAD))
    return bk, pk, ht, state, total, nonzero, caps


@pytest.fixture(scope="module", params=sorted(JOINS))
def join(request):
    return request.param, _jax_join(request.param)


def test_plan_materialize_picks_the_jax_path(join):
    path, (_, _, ht, state, total, nonzero, (k_cap, cap)) = join
    name, (jr, js, jtot), _ = jax_mj.plan_materialize(
        ht, state, k_cap, cap, total=total, nonzero=nonzero, probe_base=7)
    assert name == path
    pht, pst = _port_state(ht, state)
    pname, (r, s, tot), replay = mj.plan_materialize(
        pht, pst, k_cap, cap, total=total, nonzero=nonzero, probe_base=7)
    # the port has no runs path: K7b is its expand
    assert pname == {"runs": "expand"}.get(name, name)
    assert int(tot) == int(jtot) == total
    assert (r.numpy()[total:] == -1).all() and (s.numpy()[total:] == -1).all()
    if name == "fill" and nonzero == state.counts.shape[0]:
        # fill with every probe row matched: both compactions are the
        # identity, so bitwise (JAX's runs path compacts by its unstable
        # sort)
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_pairs(r[:total], s[:total]),
                                  _pairs(jr[:total], js[:total]))
    again = replay()
    assert torch.equal(again[0], r) and torch.equal(again[1], s)


def test_merge_join_matches_jax(join):
    path, (bk, pk, *_) = join
    jr, js = tpujoin.merge_join(bk, pk, result_pad_multiple=PAD)
    r, s = tpujoin_torch.merge_join(bk, pk, device="cpu",
                                    result_pad_multiple=PAD)
    assert r.dtype == s.dtype == np.int32
    np.testing.assert_array_equal(_pairs(r, s), _pairs(jr, js))
    assert oracle.check_join(bk, pk, r, s) == 1


def test_materialize_paths_agree_on_one_state(join):
    """fill and groups compute the same columns from one state (bitwise
    when every probe row matched), equal to expand's as a multiset."""
    _, (_, _, ht, state, total, nonzero, (k_cap, cap)) = join
    pht, pst = _port_state(ht, state)
    kw = {"total": total, "nonzero": nonzero}
    outs = {fn.__name__: fn(pht, pst, k_cap, cap, 3, **kw) for fn in (
        mj.probe_materialize_fill, mj.probe_materialize_groups,
        mj.probe_materialize)}
    want = _pairs(outs["probe_materialize"][0][:total],
                  outs["probe_materialize"][1][:total])
    for r, s, tot, fits in outs.values():
        assert bool(fits) and int(tot) == total
        np.testing.assert_array_equal(_pairs(r[:total], s[:total]), want)
    for a, b in zip(outs["probe_materialize_fill"][:2],
                    outs["probe_materialize_groups"][:2]):
        assert torch.equal(a, b)
    *_, fits = mj.probe_materialize_fill(pht, pst, k_cap, total - 1, **kw)
    assert not bool(fits)


def test_compact_and_group_heads_match_jax():
    *_, ht, state, total, nonzero, (k_cap, _) = _jax_join("fill")
    assert nonzero == state.counts.shape[0]
    jlo, jcnt, jsid, joffs, *_ = jax_mj._compact(state, k_cap,
                                                 all_matched=True)
    _, pst = _port_state(ht, state)
    cols = mj._compact(pst, k_cap, all_matched=True)
    for got, want in zip(cols, (jlo, jcnt, jsid, joffs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jgoff, jglo, jgnb, jng = jax_mj._group_heads(jlo, jcnt, joffs, k_cap,
                                                 nonzero)
    goff, glo, gnb, ng = mj._group_heads(cols[0], cols[1], cols[3], k_cap,
                                         nonzero)
    assert ng == int(jng) and 0 < ng <= JOINS["fill"][1]
    for got, want in ((goff, jgoff), (glo, jglo), (gnb, jgnb)):
        np.testing.assert_array_equal(got.numpy()[:ng],
                                      np.asarray(want)[:ng])
    assert (goff.numpy()[ng:] == np.iinfo(np.int32).max).all()
    assert int(goff[0]) == 0 and bool((glo[1:ng] > glo[:ng - 1]).all())


@pytest.mark.parametrize("all_matched", [True, False])
def test_probe_rle_matches_jax(all_matched):
    # probe keys above the build domain leave ~20% of probe rows unmatched;
    # the JAX side then compacts with its (stable) kernel
    *_, ht, state, total, nonzero, (k_cap, _) = _jax_join(
        "fill", None if all_matched else 40)
    assert (nonzero == state.counts.shape[0]) == all_matched
    if all_matched:
        want = jax_mj.probe_rle(ht, state, k_cap, all_matched=True)
    else:
        want = jax_mj.probe_rle(ht, state, k_cap, compact_step=1024)[:3]
    _, pst = _port_state(ht, state)
    got = mj.probe_rle(pst, k_cap, all_matched=all_matched)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) == total


@pytest.mark.parametrize("path", sorted(JOINS))
def test_merge_join_rle_matches_jax(path):
    rows, key_max = JOINS[path]
    bk, pk = _keys(rows, key_max, 5), _keys(rows, key_max + 8, 6)
    jpid, jlo, jcnt, jsrc = tpujoin.merge_join_rle(bk, pk)
    pid, lo, cnt, src = tpujoin_torch.merge_join_rle(bk, pk, device="cpu")
    assert all(a.dtype == np.int32 for a in (pid, lo, cnt, src))
    assert oracle.check_join_rle(bk, pk, src, pid, lo, cnt) == 1
    # the sorts may order equal keys' ids differently: rows by probe id,
    # build ids per equal-key run
    mine, theirs = np.argsort(pid), np.argsort(np.asarray(jpid))
    for a, b in ((pid, jpid), (lo, jlo), (cnt, jcnt)):
        np.testing.assert_array_equal(a[mine], np.asarray(b)[theirs])
    skeys = np.sort(bk)
    for key in np.unique(skeys):
        run = skeys == key
        np.testing.assert_array_equal(np.sort(src[run]),
                                      np.sort(np.asarray(jsrc)[run]))


def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch):
    """numpy keys without ``device`` run on CUDA: with no card they raise,
    never take the plain versions silently. CPU tensors stay on the CPU."""
    bk, pk = _keys(256, 16, 1), _keys(256, 16, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpujoin_torch.merge_join(bk, pk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpujoin_torch.merge_join_rle(bk, pk)
    r, s = tpujoin_torch.merge_join(torch.from_numpy(bk), torch.from_numpy(pk))
    assert oracle.check_join(bk, pk, r, s) == 1


def test_bench_join_dense_verifies_every_pair_on_cpu():
    cfg = JoinConfig(name="dense_small", build_rows=20_000,
                     probe_rows=20_000, key_min=1, key_max=200)
    out = bench.bench_join_dense(cfg, verify=True, device="cpu")
    assert out["verified"] is True and out["pair_kernel"] == "fill"
    assert out["pairs_checked"] == out["result_rows"] > 1 << 20
    assert out["engine"] == "v2-rle" and out["device"] == "cpu"
    assert set(out) == {
        "engine", "config", "device", "build_rows", "probe_rows",
        "result_rows", "build_seconds", "count_seconds",
        "materialize_seconds", "total_seconds", "probe_rows_per_sec",
        "hbm_peak_gbps", "verified", "pair_kernel",
        "pair_expansion_rows_per_sec", "pair_materialize_seconds",
        "total_seconds_materialized", "pairs_checked"}
