"""Multi-process execution of the port, the counterpart of
tests/test_multihost.py: two local processes join a ``torch.distributed``
process group over gloo at a free 127.0.0.1 port
(``tpujoin_torch.parallel.multihost.initialize``), build the global mesh,
take their row shards with ``put_row_sharded`` and run one shuffle-join
step; each checks its own shard's pairs key by key, and the test sums the
shards' exact totals against numpy. Then each runs the driver, which
gathers every shard's pairs onto every process.

This file is also the worker: ``python tests/test_torch_multihost.py
<rank> <world> <port> <out dir>``. The workers see no card, so the group
runs on gloo anywhere.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS_PER_RANK = 64


def _keys(world: int):
    rng = np.random.default_rng(0)
    n = ROWS_PER_RANK * world
    return (rng.integers(1, 64, n).astype(np.int32),
            rng.integers(1, 64, n).astype(np.int32))


def _expected(rk, sk) -> int:
    srk = np.sort(rk)
    return int((np.searchsorted(srk, sk, "right")
                - np.searchsorted(srk, sk, "left")).sum())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_shuffle_join(tmp_path):
    world = 2
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(world),
         str(port), str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, err.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (rc, err) in enumerate(outs):
        assert rc == 0, f"worker {rank} exited {rc}: {err[-2000:]}"

    results = [json.loads((tmp_path / f"worker_{r}.json").read_text())
               for r in range(world)]
    rk, sk = _keys(world)
    expected = _expected(rk, sk)
    assert all(r["world"] == world and r["multiprocess"] for r in results)
    assert sum(r["local_total"] for r in results) == expected
    assert all(r["driver_pairs"] == expected for r in results)


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch

    from tpujoin_torch.parallel import multihost
    from tpujoin_torch.parallel.shuffle_join import (distributed_hash_join,
                                                     make_shuffle_join_fn)

    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=world, process_id=rank)
    try:
        mesh = multihost.make_global_mesh()
        assert multihost.is_multiprocess() and mesh.shards == (rank,)
        assert mesh.size == world and mesh.device.type == "cpu"
        rk, sk = _keys(world)
        ids = np.arange(len(rk), dtype=np.int32)
        args = [multihost.put_row_sharded(x, mesh) for x in (rk, ids, sk, ids)]
        n = len(rk)
        cap = max(4096, _expected(rk, sk) + 64)
        r_out, s_out, totals, ovf = make_shuffle_join_fn(mesh, n, n, cap)(
            *args)
        t = int(totals[0])
        r, s = r_out[0][:t].numpy(), s_out[0][:t].numpy()
        assert (r >= 0).all() and (s >= 0).all() and int(ovf[2]) <= cap
        assert (rk[r] == sk[s]).all(), f"rank {rank} pair mismatch"
        r_all, s_all = distributed_hash_join(rk, sk, mesh=mesh)
        assert (rk[r_all] == sk[s_all]).all()
        assert len(set(zip(r_all.tolist(), s_all.tolist()))) == len(r_all)
        with open(os.path.join(out_dir, f"worker_{rank}.json"), "w") as f:
            json.dump({"world": torch.distributed.get_world_size(),
                       "multiprocess": multihost.is_multiprocess(),
                       "local_total": t, "driver_pairs": len(r_all)}, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
