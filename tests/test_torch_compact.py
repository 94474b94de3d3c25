"""K3, tpujoin_torch's compact3, against the JAX package's Pallas compact3
in interpret mode at its CPU profile (out_step=1024, slab=4096, the
profile tpujoin/ops/merge_join.py uses on the CPU): bitwise, on inputs
where the JAX kernel reports ``fits``.

All JAX cases share one width and k_cap so the kernel compiles once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpujoin.kernels.compact import compact3 as jax_compact3
from tpujoin_torch.kernels import compact


N = 8192
K_CAP = 4096


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
