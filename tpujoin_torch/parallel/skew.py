"""Skew-aware distributed shuffle join: heavy-hitter splitting (the port of
tpujoin/parallel/skew.py).

A range or hash partition sends every row of a key to one shard, so a Zipf
head key overloads one shard. The split (two-sided partial
repartitioning):

1. **Detect**: each shard nominates its top-H locally most frequent keys a
   side; one ``all_gather`` merges them into a global candidate list
   (2 H P keys, sorted, the same on every shard), and exact global counts
   of each candidate come from local searchsorted counts and an
   ``all_reduce`` sum. A key is heavy when either side's global count
   passes ``heavy_factor`` x that side's rows / P.
2. **Split**: for each heavy key the side with fewer rows is replicated to
   every shard (``all_gather``) and the other side is sprayed round-robin
   over the shards through the normal ``all_to_all`` buffers. Every pair
   still meets exactly once: a sprayed row's shard holds all its
   replicated partners.
3. **Join**: each shard joins (received ++ gathered replicas) build rows
   against the same for the probe side: one sorted local join.

Every buffer has a fixed capacity, with the same detect-and-retry
telemetry as the plain program. The local sorts run on K1; the routing
hash is ``ops/radix.py:partition_ids``.
"""
from __future__ import annotations

import numpy as np
import torch

from tpujoin_torch.kernels.merge_sort import sort_pairs
from tpujoin_torch.ops.radix import partition_ids
from tpujoin_torch.parallel.mesh import Mesh
from tpujoin_torch.parallel.shuffle_join import (BUILD_PAD_KEY, CAP_GRANULE,
                                                 PROBE_PAD_KEY, _local_join,
                                                 _mesh_for, _n_real,
                                                 _pack_sorted,
                                                 _segment_bounds,
                                                 _sharded_inputs,
                                                 _sorted_splitters,
                                                 _telemetry, _trimmed)
from tpujoin_torch.utils.shapes import round_up


def _sorted_keys(keys, ids, pad_key: int):
    """The keys sorted on K1, driver pads (id < 0) as ``pad_key``."""
    return sort_pairs(torch.where(ids >= 0, keys, pad_key), ids)[0]


def _local_top_keys(keys, ids, h: int, pad_key: int):
    """The top-h locally most frequent keys, pad_key where there are fewer;
    ties go to the smaller key, as ``jax.lax.top_k`` breaks them."""
    sk = _sorted_keys(keys, ids, pad_key)
    cnt = (torch.searchsorted(sk, sk, right=True, out_int32=True)
           - torch.searchsorted(sk, sk, out_int32=True))
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    score = torch.where(first & (sk != pad_key), cnt, 0)
    idx = torch.sort(score, descending=True, stable=True).indices[:h]
    top = torch.where(score[idx] > 0, sk[idx], pad_key)
    return torch.cat([top, top.new_full((h - top.shape[0],), pad_key)])


def _counts_in(sorted_local, queries):
    return (torch.searchsorted(sorted_local, queries, right=True,
                               out_int32=True)
            - torch.searchsorted(sorted_local, queries, out_int32=True))


def _detect(mesh: Mesh, r_keys, r_ids, s_keys, s_ids, top_h: int,
            heavy_factor: float):
    """(cand, mode): the sorted global candidate keys and each one's route,
    0 normal, 1 replicate the build side and spray the probe side, 2 the
    converse; the same on every shard."""
    cand = mesh.all_gather([
        torch.cat([_local_top_keys(rk, ri, top_h, BUILD_PAD_KEY),
                   _local_top_keys(sk, si, top_h, BUILD_PAD_KEY)])
        for rk, ri, sk, si in zip(r_keys, r_ids, s_keys, s_ids)])[0]
    cand = torch.sort(cand).values
    thr = []
    counts = []
    for keys, ids in ((r_keys, r_ids), (s_keys, s_ids)):
        counts.append(mesh.all_reduce(
            [_counts_in(_sorted_keys(k, i, BUILD_PAD_KEY), cand)
             for k, i in zip(keys, ids)], "sum"))
        base = mesh.all_reduce([(i >= 0).sum(dtype=torch.int32)
                                for i in ids], "sum") // mesh.size
        # heavy_factor scales the fair share in f32, floored to an int
        factor = torch.tensor(max(float(heavy_factor), 0.0),
                              dtype=torch.float32, device=base.device)
        thr.append(torch.clamp((factor * base.float()).to(torch.int32),
                               min=1))
    gr, gs = counts
    heavy = ((gr > thr[0]) | (gs > thr[1])) & (cand != BUILD_PAD_KEY)
    mode = torch.where(heavy, torch.where(gr <= gs, 1, 2), 0)
    return cand, mode.to(torch.int32)


def _lookup_mode(cand, mode, keys):
    slot = torch.searchsorted(cand, keys).clamp_(0, cand.shape[0] - 1)
    return torch.where(cand[slot] == keys, mode[slot], 0)


def _route(keys, ids, rep_mask, spray_mask, num_peers: int, me: int):
    """Order the rows by destination: peers 0..P-1 (hash partition, or
    round-robin from ``me`` for sprayed rows), then the replicated rows
    (P), then driver pads (P + 1). Returns (keys, ids, starts, counts) with
    [P + 1] int32 starts and counts of the P peers and the replicas."""
    n = keys.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=keys.device)
    pid = torch.where(spray_mask, (pos + me) % num_peers,
                      partition_ids(keys, num_peers))
    pid = torch.where(rep_mask, num_peers, pid)
    pid = torch.where(ids < 0, num_peers + 1, pid).to(torch.int32)
    spid, order = sort_pairs(pid, pos)
    order = order.long()
    bounds = torch.arange(num_peers + 1, dtype=torch.int32,
                          device=keys.device)
    starts = torch.searchsorted(spid, bounds, out_int32=True)
    ends = torch.searchsorted(spid, bounds, right=True, out_int32=True)
    return keys[order], ids[order], starts, ends - starts


def _routes(mesh: Mesh, r_keys, r_ids, s_keys, s_ids, top_h: int,
            heavy_factor: float):
    """Detect, then route every held shard's rows of both sides: a list a
    side of (keys, ids, starts, counts) a held shard."""
    cand, mode = _detect(mesh, r_keys, r_ids, s_keys, s_ids, top_h,
                         heavy_factor)
    out = []
    for keys, ids, rep, spray in ((r_keys, r_ids, 1, 2),
                                  (s_keys, s_ids, 2, 1)):
        side = []
        for me, k, i in zip(mesh.shards, keys, ids):
            m = _lookup_mode(cand, mode, k)
            side.append(_route(k, i, m == rep, m == spray, mesh.size, me))
        out.append(side)
    return out


def make_skew_join_fn(mesh: Mesh, send_cap_r: int, send_cap_s: int,
                      rep_cap_r: int, rep_cap_s: int, local_result_cap: int,
                      top_h: int = 64, heavy_factor: float = 1.0):
    """The skew-aware join step. The contract of
    shuffle_join.make_shuffle_join_fn, with the replica telemetry: ovf is
    [build segment, probe segment, largest shard total, replicated build
    rows, replicated probe rows] (mesh-wide maxima, int64)."""
    p = mesh.size

    def step(r_keys, r_ids, s_keys, s_ids):
        routes = _routes(mesh, r_keys, r_ids, s_keys, s_ids, top_h,
                         heavy_factor)
        cols, maxes = [], []
        for side, cap, rcap, pad in zip(routes, (send_cap_r, send_cap_s),
                                        (rep_cap_r, rep_cap_s),
                                        (BUILD_PAD_KEY, PROBE_PAD_KEY)):
            norm = [_pack_sorted(k, i, st[:p], ct[:p], cap, pad)
                    for k, i, st, ct in side]
            rep = [_pack_sorted(k, i, st[p:], ct[p:], rcap, pad)
                   for k, i, st, ct in side]
            rk = mesh.all_to_all([x[0] for x in norm])
            ri = mesh.all_to_all([x[1] for x in norm])
            gk = mesh.all_gather([x[0].view(-1) for x in rep])
            gi = mesh.all_gather([x[1].view(-1) for x in rep])
            cols.append(([torch.cat([a.view(-1), b]) for a, b in zip(rk, gk)],
                         [torch.cat([a.view(-1), b]) for a, b in zip(ri, gi)]))
            maxes.append(([x[2] for x in norm], [x[3][p].long()
                                                 for x in side]))
        outs = [_local_join(bk, bi, pk, pi, local_result_cap)
                for bk, bi, pk, pi in zip(*cols[0], *cols[1])]
        totals = [o[2] for o in outs]
        ovf = _telemetry(mesh, maxes[0][0], maxes[1][0], totals,
                         maxes[0][1], maxes[1][1])
        return ([o[0] for o in outs], [o[1] for o in outs],
                [t.view(1) for t in totals], ovf)
    return step


def shard_rows(r_keys, s_keys, *, mesh: Mesh | None = None,
               skew: bool = False, top_h: int = 64,
               heavy_factor: float = 1.0,
               device: torch.device | str | None = None) -> np.ndarray:
    """The real rows (build + probe) each shard receives to join, [P]
    int64, under the plain program's range partition or, with ``skew``,
    the skew program's routes (replicas count on every shard). The
    exchange's exact counts, summed over the mesh: no buffer is sent."""
    mesh = _mesh_for(mesh, device, r_keys, s_keys)
    p = mesh.size
    rk, ri, sk, si = _sharded_inputs(mesh, r_keys, s_keys)
    if skew:
        counts = [ct.long() for side in _routes(mesh, rk, ri, sk, si, top_h,
                                                heavy_factor)
                  for *_, ct in side]
        total = mesh.all_reduce([sum(counts[d::len(mesh.shards)])
                                 for d in range(len(mesh.shards))], "sum")
        return (total[:p] + total[p]).cpu().numpy()
    rs, ss, spl = _sorted_splitters(mesh, rk, ri, sk, si)
    counts = [_segment_bounds(k, spl, _n_real(i))[1].long()
              for k, i in rs + ss]
    return mesh.all_reduce([counts[d] + counts[d + len(rs)]
                            for d in range(len(rs))], "sum").cpu().numpy()


def distributed_hash_join_skew(r_keys, s_keys, *, mesh: Mesh | None = None,
                               slack: float = 2.0,
                               expected_matches: int | None = None,
                               max_retries: int = 4, top_h: int = 64,
                               device: torch.device | str | None = None):
    """Driver: the exact distributed join with heavy-hitter splitting. The
    contract of shuffle_join.distributed_hash_join."""
    mesh = _mesh_for(mesh, device, r_keys, s_keys)
    p = mesh.size
    n, m = len(r_keys), len(s_keys)
    rk, ri, sk, si = _sharded_inputs(mesh, r_keys, s_keys)
    if expected_matches is None:
        expected_matches = max(n, m)
    cap_r = round_up(int(n // (p * p) * slack) + 64, CAP_GRANULE)
    cap_s = round_up(int(m // (p * p) * slack) + 64, CAP_GRANULE)
    rep_r = rep_s = round_up(top_h * 4, CAP_GRANULE)
    cap_res = round_up(int(expected_matches / p * slack) + 64, CAP_GRANULE)
    for _ in range(max_retries):
        r_out, s_out, totals, ovf = make_skew_join_fn(
            mesh, cap_r, cap_s, rep_r, rep_s, cap_res, top_h=top_h)(
            rk, ri, sk, si)
        ovf = ovf.tolist()
        if (ovf[0] <= cap_r and ovf[1] <= cap_s and ovf[2] <= cap_res
                and ovf[3] <= rep_r and ovf[4] <= rep_s):
            break
        cap_r = max(cap_r, round_up(ovf[0], CAP_GRANULE))
        cap_s = max(cap_s, round_up(ovf[1], CAP_GRANULE))
        cap_res = max(cap_res, round_up(ovf[2], CAP_GRANULE))
        rep_r = max(rep_r, round_up(ovf[3], CAP_GRANULE))
        rep_s = max(rep_s, round_up(ovf[4], CAP_GRANULE))
    else:
        raise RuntimeError(f"skew join capacities did not converge: {ovf}")
    return _trimmed(mesh, r_out, totals), _trimmed(mesh, s_out, totals)
