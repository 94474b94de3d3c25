"""K3 and K6, tpujoin_torch's compact3, compact_ids and compact_cols,
against the JAX package's Pallas kernels in interpret mode at their CPU
profile (out_step=1024, slab=4096, the profile tpujoin/ops/merge_join.py
and tests/test_compact.py use on the CPU): bitwise over every k_cap slot,
tail included, on inputs where the JAX kernel reports ``fits``.

All JAX cases share one width so each kernel compiles once per k_cap and
mask type.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.kernels.compact import compact3 as jax_compact3
from tpujoin.kernels.compact import compact_cols as jax_compact_cols
from tpujoin.kernels.compact import compact_ids as jax_compact_ids
from tpujoin_torch.kernels import compact


N = 8192
K_CAP = 4096
JAX_CPU = {"out_step": 1024, "slab": 4096, "interpret": True}


def _case(n: int, sel: float, seed: int):
    rng = np.random.default_rng(seed)
    flag = rng.random(n) < sel
    cnt = np.where(flag, rng.integers(1, 6, n), 0).astype(np.int32)
    lo = np.sort(rng.integers(0, 1 << 20, n)).astype(np.int32)
    sid = rng.permutation(n).astype(np.int32)
    return lo, cnt, sid


@pytest.mark.parametrize("sel,seed", [
    (0.30, 2),    # nonzero < k_cap: zero tail
    (0.55, 1),    # nonzero > k_cap: the first k_cap rows
    (0.95, 0),
    (1.0, 3),
])
def test_matches_jax_compact3(sel, seed):
    lo, cnt, sid = _case(N, sel, seed)
    jl, jc, js, fits = jax_compact3(jnp.asarray(lo), jnp.asarray(cnt),
                                    jnp.asarray(sid), K_CAP, out_step=1024,
                                    slab=4096, interpret=True)
    assert bool(fits)
    got = compact.compact3(torch.from_numpy(lo), torch.from_numpy(cnt),
                           torch.from_numpy(sid), K_CAP)
    for g, j in zip(got, (jl, jc, js)):
        assert g.dtype == torch.int32 and g.shape == (K_CAP,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_plain_matches_mask_compaction():
    lo, cnt, sid = _case(1000, 0.1, 4)
    keep = cnt > 0
    k = int(keep.sum())
    got = compact.compact3(torch.from_numpy(lo), torch.from_numpy(cnt),
                           torch.from_numpy(sid), k + 10)
    for g, col in zip(got, (lo, cnt, sid)):
        np.testing.assert_array_equal(g.numpy()[:k], col[keep])
        assert not g.numpy()[k:].any()


@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
@pytest.mark.parametrize("k_cap", [2048, 8192])   # below / above nonzero
@pytest.mark.parametrize("sel,seed", [(0.5, 0), (0.9, 1), (1.0, 2)])
def test_compact_ids_matches_jax(sel, seed, k_cap, dtype):
    mask = (np.random.default_rng(seed).random(N) < sel).astype(dtype)
    ids, nonzero, fits = jax_compact_ids(jnp.asarray(mask), k_cap, **JAX_CPU)
    assert bool(fits)
    got, got_nonzero = compact.compact_ids(torch.from_numpy(mask), k_cap)
    assert got.dtype == torch.int32 and got.shape == (k_cap,)
    assert got_nonzero.dtype == torch.int64 and got_nonzero.dim() == 0
    assert int(got_nonzero) == int(nonzero) == int(mask.sum())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ids))


def _ids_mask(n: int, seed: int, dtype):
    """A 0/1 mask of n rows (the JAX kernel's domain), ~40% set."""
    return (np.random.default_rng(seed).random(n) < 0.4).astype(dtype)


def _ids_against_jax(mask_np, mask_t, k_cap):
    ids, nonzero, fits = jax_compact_ids(jnp.asarray(mask_np), k_cap,
                                         **JAX_CPU)
    assert bool(fits)
    got, got_nonzero = compact.compact_ids(mask_t, k_cap)
    assert got.shape == (k_cap,) and int(got_nonzero) == int(nonzero)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ids))


@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
@pytest.mark.parametrize("n", [1, 17, 4099])
def test_compact_ids_ragged_length_matches_jax(n, dtype):
    """Lengths that are no multiple of a 16-byte load or of a tile."""
    mask = _ids_mask(n, n, dtype)
    _ids_against_jax(mask, torch.from_numpy(mask), 2048)


@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
@pytest.mark.parametrize("offset", [1, 7, 15])
def test_compact_ids_sliced_view_matches_jax(offset, dtype):
    """A contiguous view starting ``offset`` rows into its storage: the
    ids count from the view's first row."""
    base = _ids_mask(N + 16, offset, dtype)
    view = torch.from_numpy(base)[offset:offset + N]
    assert view.storage_offset() == offset and view.is_contiguous()
    _ids_against_jax(base[offset:offset + N], view, 2048)


@pytest.mark.parametrize("sel,seed", [(0.6, 5), (0.35, 6)])
def test_compact_cols_matches_jax(sel, seed):
    """Six columns with negative values, the aggregate value path's
    width."""
    rng = np.random.default_rng(seed)
    mask = (rng.random(N) < sel).astype(np.int32)
    cols = [rng.integers(-1000, 1 << 20, N).astype(np.int32)
            for _ in range(6)]
    k_cap = 2048
    outs, nonzero, fits = jax_compact_cols(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in cols), k_cap,
        **JAX_CPU)
    assert bool(fits)
    got, got_nonzero = compact.compact_cols(
        torch.from_numpy(mask), [torch.from_numpy(c) for c in cols], k_cap)
    assert int(got_nonzero) == int(nonzero)
    for g, j in zip(got, outs, strict=True):
        assert g.dtype == torch.int32 and g.shape == (k_cap,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
def test_all_zero_mask_matches_jax(dtype):
    mask = np.zeros(N, dtype)
    ids, nonzero, fits = jax_compact_ids(jnp.asarray(mask), 2048, **JAX_CPU)
    assert bool(fits) and int(nonzero) == 0
    got, got_nonzero = compact.compact_ids(torch.from_numpy(mask), 2048)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ids))
    assert int(got_nonzero) == 0 and (got == -1).all()
    cols, nz = compact.compact_cols(torch.from_numpy(mask),
                                    [torch.arange(N, dtype=torch.int32)], 64)
    assert int(nz) == 0 and not cols[0].any()


def test_empty_mask():
    ids, nonzero = compact.compact_ids(torch.zeros(0, dtype=torch.bool), 16)
    assert int(nonzero) == 0 and (ids == -1).all() and ids.shape == (16,)
    (col,), nonzero = compact.compact_cols(
        torch.zeros(0, dtype=torch.int32), [torch.zeros(0, dtype=torch.int32)],
        16)
    assert int(nonzero) == 0 and not col.any() and col.shape == (16,)


def test_i32_mask_keeps_positive_rows_only():
    """An int32 mask keeps the rows > 0, as the JAX kernels do: a negative
    entry is not set."""
    mask = torch.tensor([3, -1, 0, 1, -7, 2], dtype=torch.int32)
    ids, nonzero = compact.compact_ids(mask, 6)
    assert ids.tolist() == [0, 3, 5, -1, -1, -1] and int(nonzero) == 3
    with pytest.raises(ValueError):
        compact.compact_ids(mask.long(), 6)
