"""The port's pipelined shuffle join against the JAX package's, on an
8-shard in-process CPU mesh against JAX's 8 emulated CPU devices
(tests/conftest.py), with Pallas in interpret mode: the counterparts of
tests/test_dist.py:79-100. Kept apart from test_torch_dist.py for its
time: each JAX pipelined step compiles for ~8-12 s here.

Per-chunk totals and telemetry are compared bitwise, the pairs of each
shard's chunks as multisets, whole results against the native oracle.
"""
import numpy as np
import pytest
import torch

import tpujoin_torch
from tpujoin.parallel import shuffle_join as jsj
from tpujoin.parallel.mesh import make_mesh as jax_mesh
from tpujoin_torch import oracle
from tpujoin_torch.parallel import shuffle_join as tsj
from tpujoin_torch.parallel.mesh import make_mesh
from test_torch_dist import _jax_args, _padded, _pair_sets, _rand


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh(8), make_mesh(8, device="cpu")


@pytest.mark.parametrize("n,m,dom,seed,chunks", [
    (4096, 4096, 300, 11, 4),
    (3001, 5003, 100, 13, 2),        # ragged: 8 x 2 divides neither side
])
def test_pipelined_program_matches_jax(meshes, n, m, dom, seed, chunks):
    """Per-chunk totals, telemetry and pairs of each shard's chunks
    bitwise against JAX's pipelined step at the same caps; the driver
    against the oracle."""
    jm, tm = meshes
    rk, sk = _rand(n, 1, dom, seed), _rand(m, 1, dom, seed + 1)
    cols = [*_padded(rk, 8), *_padded(sk, 8 * chunks)]
    cap_s = sk.shape[0] // chunks + 64
    cap = oracle.join_count(rk, sk) + 64
    j_out = jsj.make_shuffle_join_pipelined_fn(jm, n, cap_s, cap, chunks)(
        *_jax_args(jm, cols))
    t_out = tsj.make_shuffle_join_pipelined_fn(tm, n, cap_s, cap, chunks)(
        *[tm.put_rows(c) for c in cols])
    totals = torch.cat(t_out[2]).numpy()
    np.testing.assert_array_equal(totals, np.asarray(j_out[2]))
    np.testing.assert_array_equal(t_out[3].numpy(), np.asarray(j_out[3])[:3])
    assert (_pair_sets(torch.cat(t_out[0]), torch.cat(t_out[1]), totals,
                       8 * chunks)
            == _pair_sets(j_out[0], j_out[1], j_out[2], 8 * chunks))
    r_ids, s_ids = tpujoin_torch.distributed_hash_join(
        rk, sk, mesh=tm, expected_matches=oracle.join_count(rk, sk),
        pipeline_chunks=chunks)
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1


@pytest.mark.parametrize("chunks", [2, 4])
def test_pipelined_driver_matches_oracle(meshes, chunks):
    rk, sk = _rand(4096, 1, 300, 11), _rand(4096, 1, 300, 12)
    r_ids, s_ids = tpujoin_torch.distributed_hash_join(
        rk, sk, mesh=meshes[1], expected_matches=oracle.join_count(rk, sk),
        pipeline_chunks=chunks)
    assert oracle.check_join(rk, sk, r_ids, s_ids) == 1
