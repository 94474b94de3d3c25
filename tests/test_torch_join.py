"""The slice end to end: tpujoin_torch's build, count, materialize and
merge_join against the JAX package's, on the same numpy inputs.

State carries across through ``HashJoinTable.from_numpy`` and
``SortedProbe.from_numpy``: the JAX build's and count's state goes into the
port's count and materialize, whose outputs must then match bitwise. Both
sorts may order equal keys' ids differently, so a sort's ids are compared
per equal-key run and the join's pairs as an exact multiset.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpujoin
import tpujoin_torch
from tpujoin.ops import hash_join as jax_hj
from tpujoin.ops import merge_join as jax_mj
from tpujoin_torch import oracle
from tpujoin_torch.ops import merge_join as mj
from tpujoin_torch.ops.hash_join import HashJoinTable, build


SMALL = tpujoin_torch.PRESETS["test_small"]
N = 1 << 14
LOW_SEL_KEYS = 150_000   # ~10% of probe rows match at N x N


def _keys(n, key_max, seed):
    return np.random.default_rng(seed).integers(1, key_max + 1, n).astype(
        np.int32)


def _runs(keys, ids):
    order = np.lexsort((ids, keys))
    return np.stack([keys[order], ids[order]])


def _pairs(r, s):
    return np.sort(r.astype(np.int64) << 32 | s.astype(np.int64))


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's build and count state on test_small keys."""
    bk = _keys(SMALL.build_rows, SMALL.key_max, 1)
    pk = _keys(SMALL.probe_rows, SMALL.key_max, 2)
    ht = jax_hj.build(jnp.asarray(bk))
    state, total, nonzero = jax_mj.probe_count(ht, jnp.asarray(pk))
    return bk, pk, ht, state, int(total), int(nonzero)


def test_build_matches_jax(jax_state):
    bk, _, ht, *_ = jax_state
    port = build(torch.from_numpy(bk))
    np.testing.assert_array_equal(port.sorted_keys.numpy(),
                                  np.asarray(ht.sorted_keys))
    np.testing.assert_array_equal(
        _runs(port.sorted_keys.numpy(), port.sorted_ids.numpy()),
        _runs(np.asarray(ht.sorted_keys), np.asarray(ht.sorted_ids)))


def test_count_on_jax_build_state_matches_jax(jax_state):
    _, pk, ht, state, total, nonzero = jax_state
    port_ht = HashJoinTable.from_numpy(np.asarray(ht.sorted_keys),
                                       np.asarray(ht.sorted_ids))
    st, tot, nz = mj.probe_count(port_ht, torch.from_numpy(pk))
    assert (int(tot), int(nz)) == (total, nonzero)
    assert tot.dtype == torch.int64
    np.testing.assert_array_equal(st.lo.numpy(), np.asarray(state.lo))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(state.counts))
    np.testing.assert_array_equal(
        _runs(pk[st.probe_ids.numpy()], st.probe_ids.numpy()),
        _runs(pk[np.asarray(state.probe_ids)], np.asarray(state.probe_ids)))


@pytest.mark.parametrize("probe_base", [0, 1000])
def test_materialize_on_jax_state_matches_jax(jax_state, probe_base):
    """Bitwise against the JAX materialize with its compaction kernel (the
    stable compaction; its sort fallback is unstable)."""
    _, _, ht, state, total, nonzero = jax_state
    k_cap, cap = 4096, total + 1000
    jr, js, jtot, jfits = jax_mj.probe_materialize(
        ht, state, k_cap, cap, probe_base=probe_base, compact_step=1024)
    assert bool(jfits)
    port_ht = HashJoinTable.from_numpy(np.asarray(ht.sorted_keys),
                                       np.asarray(ht.sorted_ids))
    port_st = mj.SortedProbe.from_numpy(np.asarray(state.probe_ids),
                                        np.asarray(state.lo),
                                        np.asarray(state.counts))
    r, s, tot, fits = mj.probe_materialize(port_ht, port_st, k_cap, cap,
                                           probe_base, total=total,
                                           nonzero=nonzero)
    assert bool(fits) and int(tot) == int(jtot) == total
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (r.numpy()[total:] == -1).all() and (s.numpy()[total:] == -1).all()


def test_materialize_reports_undersized_capacity(jax_state):
    _, _, ht, state, total, nonzero = jax_state
    port_ht = HashJoinTable.from_numpy(np.asarray(ht.sorted_keys),
                                       np.asarray(ht.sorted_ids))
    port_st = mj.SortedProbe.from_numpy(np.asarray(state.probe_ids),
                                        np.asarray(state.lo),
                                        np.asarray(state.counts))
    *_, fits = mj.probe_materialize(port_ht, port_st, nonzero, total - 1,
                                    total=total, nonzero=nonzero)
    assert not bool(fits)


@pytest.mark.parametrize("case", ["test_small", "low_sel", "low_sel_chunked"])
def test_merge_join_matches_jax(case):
    if case == "test_small":
        bk = _keys(SMALL.build_rows, SMALL.key_max, 3)
        pk = _keys(SMALL.probe_rows, SMALL.key_max, 4)
        kw = {"probe_chunk_rows": SMALL.probe_chunk_rows,
              "result_pad_multiple": SMALL.result_pad_multiple}
    else:
        bk = _keys(N, LOW_SEL_KEYS, 5)
        pk = _keys(N, LOW_SEL_KEYS, 6)
        kw = {"result_pad_multiple": 1024}
        if case == "low_sel_chunked":
            kw["probe_chunk_rows"] = 5000   # 4 chunks, the last ragged
    jr, js = tpujoin.merge_join(bk, pk, **kw)
    r, s = tpujoin_torch.merge_join(bk, pk, **kw)
    assert r.dtype == s.dtype == np.int32
    np.testing.assert_array_equal(_pairs(r, s), _pairs(jr, js))
    assert oracle.check_join(bk, pk, r, s) == 1


def test_merge_join_empty_and_disjoint():
    e = np.empty(0, np.int32)
    r, s = tpujoin_torch.merge_join(e, e)
    assert r.shape == s.shape == (0,)
    r, s = tpujoin_torch.merge_join(np.arange(1, 100, dtype=np.int32),
                                    np.arange(200, 300, dtype=np.int32))
    assert r.shape == s.shape == (0,)
