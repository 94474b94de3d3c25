"""The six-program dry run of the distributed join (the port of
``__graft_entry__.py:dryrun_multichip``)."""
from __future__ import annotations

import numpy as np
import torch


def dryrun_multichip(n_devices: int,
                     device: torch.device | str | None = None) -> None:
    """Run each of the six distributed programs once over an
    ``n_devices``-shard mesh (:func:`tpujoin_torch.parallel.mesh.make_mesh`
    on ``device``) on tiny inputs, and assert exact global results against
    a numpy recompute (AssertionError on a mismatch):

      1. the plain shuffle join (one local key sort, splitter range
         partition, fixed send segments, all_to_all, local sorted join,
         summed counts): the exact count;
      2. the skew join (candidates all_gathered, global counts summed, a
         heavy key replicated on one side and sprayed on the other): the
         exact count;
      3. the pipelined shuffle join (the probe side in 2 chunks): the
         exact count;
      4. the RLE join: the exact global pair count and the exact expanded
         pair multiset;
      5. the semi join: the exact id set;
      6. the anti join: the exact id set.
    """
    from tpujoin_torch.parallel.mesh import make_mesh
    from tpujoin_torch.parallel.shuffle_join import (
        distributed_anti_join, distributed_hash_join_rle,
        distributed_semi_join, make_shuffle_join_fn,
        make_shuffle_join_pipelined_fn)
    from tpujoin_torch.parallel.skew import make_skew_join_fn

    mesh = make_mesh(n_devices, device=device)
    n = 64 * mesh.size
    rng = np.random.default_rng(0)
    rk = rng.integers(1, 64, n).astype(np.int32)
    sk = rng.integers(1, 64, n).astype(np.int32)
    # a heavy key, so that the skew program routes replicas
    rk[::4] = 7
    sk[::3] = 7
    ids = np.arange(n, dtype=np.int32)
    args = [mesh.put_rows(x) for x in (rk, ids, sk, ids)]

    order = np.argsort(rk, kind="stable")
    match_lo = np.searchsorted(rk[order], sk, "left")
    match_hi = np.searchsorted(rk[order], sk, "right")
    expected = int((match_hi - match_lo).sum())

    def total(out) -> int:
        """The global pair count of a step's per-shard totals."""
        return int(mesh.all_reduce([t.sum() for t in out[2]], "sum"))

    cap = max(4096, expected + 64)
    got = total(make_shuffle_join_fn(mesh, n, n, cap)(*args))
    _check(got == expected, f"plain dryrun count {got} != {expected}")

    out = make_skew_join_fn(mesh, n, n, n, n, cap, top_h=8,
                            heavy_factor=0.5)(*args)
    got = total(out)
    _check(got == expected, f"skew dryrun count {got} != {expected}")
    _check(int(out[3][2]) <= cap, f"skew dryrun result overflow {out[3]}")

    got = total(make_shuffle_join_pipelined_fn(mesh, n, n, cap, 2)(*args))
    _check(got == expected, f"pipelined dryrun count {got} != {expected}")

    cnt = match_hi - match_lo
    j = (np.arange(expected) - np.repeat(np.cumsum(cnt) - cnt, cnt)
         + np.repeat(match_lo, cnt))
    exp_pairs = np.stack([order[j], np.repeat(np.arange(n), cnt)], axis=1)
    shards, total_pairs = distributed_hash_join_rle(rk, sk, mesh=mesh)
    _check(total_pairs == expected,
           f"rle dryrun pair count {total_pairs} != {expected}")
    got_pairs = []
    for sh in shards:
        keep = sh["cnt"] > 0
        lo, cnt = sh["lo"][keep], sh["cnt"][keep]
        j = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        got_pairs.append(np.stack([sh["build_ids"][np.repeat(lo, cnt) + j],
                                   np.repeat(sh["probe_ids"][keep], cnt)],
                                  axis=1))
    got_pairs = np.concatenate(got_pairs)
    _check(np.array_equal(_lexsorted(got_pairs), _lexsorted(exp_pairs)),
           "rle dryrun pair multiset")

    exp_semi = np.nonzero(match_hi > match_lo)[0]
    exp_anti = np.nonzero(match_hi == match_lo)[0]
    got_semi = distributed_semi_join(rk, sk, mesh=mesh)
    got_anti = distributed_anti_join(rk, sk, mesh=mesh)
    _check(np.array_equal(got_semi, exp_semi), "semi dryrun id set")
    _check(np.array_equal(got_anti, exp_anti), "anti dryrun id set")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _lexsorted(pairs: np.ndarray) -> np.ndarray:
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
