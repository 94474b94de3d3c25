"""Distributed shuffle join over a row mesh: the sorted range shuffle (the
port of tpujoin/parallel/shuffle_join.py).

1. Tables are row-sharded over the mesh. Each shard sorts its (key, id)
   rows once on K1, and P - 1 global splitter keys are agreed from
   ``SAMPLE_K`` evenly strided samples of each sorted table, gathered from
   every shard and sorted: the same on every shard, so equal keys fall in
   the same bucket on every shard and in both tables.
2. The partition is monotone in the key, so each peer's rows are one
   contiguous segment of the sorted order: the fixed [P, C] send buffer
   is one gather (slot (p, c) takes row starts[p] + c while c < counts[p],
   else the pad), with no loop over peers.
3. One ``all_to_all`` a column exchanges the buffers.
4. Each shard sorts its received rows a side on K1 (the P received
   segments interleave; the sort also sinks the pad rows) and joins them
   on the v2 pipeline: K2 ``merge_count``, K3 ``compact3``, an exclusive
   cumsum, K4 ``expand`` and one gather of the sorted build ids masked to
   the shard's exact total.
5. ``all_reduce`` max gives the overflow telemetry [most rows sent to one
   peer by one shard, build and probe; the largest shard result], and the
   drivers retry with larger capacities: nothing is dropped silently.

Every program is written over the list of shards the process holds
(:mod:`tpujoin_torch.parallel.mesh`), its stages separated by the mesh's
collectives. A mesh of one shard still runs every collective.

Reserved sentinels: no key on either side may equal 0x7FFFFFFE or
0x7FFFFFFF, the probe and build pad keys (as on one card).

Not ported (TPU-only): the compaction kernel's output step and its
coverage flag with the sort fallback (Hopper's K3 fits any input), the
sort compaction, the 2^16 capacity granule that let XLA executables
repeat (capacities round to 64 here), and the 30-bit split of the RLE
pair count at the x32 ``shard_map`` boundary (counts are int64 here).
"""
from __future__ import annotations

import numpy as np
import torch

from tpujoin_torch.kernels.compact import compact3
from tpujoin_torch.kernels.expand import expand
from tpujoin_torch.kernels.merge_count import merge_count
from tpujoin_torch.kernels.merge_sort import sort_pairs
from tpujoin_torch.parallel.mesh import Mesh, make_mesh
from tpujoin_torch.utils.device import resolve_device
from tpujoin_torch.utils.shapes import cdiv, round_up

BUILD_PAD_KEY = 0x7FFFFFFF   # sorts last, never matches a probe key
PROBE_PAD_KEY = 0x7FFFFFFE   # sorts last, never matches a build key
SAMPLE_K = 1024              # quantile samples a table a shard
CAP_GRANULE = 64             # capacities are multiples of this


# ---- shard-local steps (one shard's tensors) ----

def _sort2(keys, ids, pad_key: int):
    """Local (key, id) sort on K1, driver pads (id < 0) repainted to the
    side's sentinel so that they sink to the tail."""
    return sort_pairs(torch.where(ids < 0, pad_key, keys), ids)


def _n_real(ids):
    """Rows before the driver-pad tail (pads carry id < 0), a 0-d tensor."""
    return ids.shape[0] - (ids < 0).sum(dtype=torch.int32)


def _quantile_sample(keys, k: int):
    """[min(k, n)] evenly strided keys: quantiles when ``keys`` is
    sorted."""
    n = keys.shape[0]
    k = min(k, n)
    stride = max(n // k, 1)
    idx = (torch.arange(k, device=keys.device) * stride).clamp_(max=n - 1)
    return keys[idx]


def _segment_bounds(sorted_keys, splitters, n_real):
    """(starts, counts), int32 [P]: peer p's contiguous bucket of the
    local sorted order, the keys in [splitter[p - 1], splitter[p]). The
    left bound keeps equal keys whole; ``n_real`` caps every bound, so
    driver pads are never sent."""
    inner = torch.searchsorted(sorted_keys, splitters, out_int32=True)
    inner = torch.minimum(inner, n_real)
    starts = torch.cat([inner.new_zeros(1), inner])
    ends = torch.cat([starts[1:], n_real.view(1)])
    return starts, ends - starts


def _pack_sorted(skeys, sids, starts, counts, capacity: int, pad_key: int):
    """The [P, capacity] send buffers of keys and ids from contiguous
    segments, one gather a column: slot (p, c) takes row starts[p] + c
    while c < counts[p], else (pad_key, -1). Returns (keys, ids, the
    largest count); a count above ``capacity`` is a send overflow."""
    c = torch.arange(capacity, dtype=torch.int32, device=skeys.device)
    valid = c < counts[:, None]
    row = (starts[:, None] + c).clamp_(max=max(skeys.shape[0] - 1, 0))
    row = row.long()
    bk = torch.where(valid, skeys[row], pad_key)
    bi = torch.where(valid, sids[row], -1)
    return bk, bi, counts.max().long()


def _sort_build(bk, bid):
    """Sort received build rows once (pad rows sink to the tail)."""
    return sort_pairs(torch.where(bid < 0, BUILD_PAD_KEY, bk), bid)


def _count_sorted(sk, pk, pid):
    """The count phase of the local join: sort the received probe rows on
    K1, then K2 against the sorted build keys. Returns (psk, ppid, lo,
    cnt) in sorted-probe order."""
    psk, ppid = sort_pairs(torch.where(pid < 0, PROBE_PAD_KEY, pk), pid)
    lo, cnt = merge_count(sk, psk)
    return psk, ppid, lo, cnt


def _materialize_counted(sid_sorted, ppid, lo, cnt, capacity: int):
    """The local materialize at a fixed result capacity: K3 to the matched
    rows, the exclusive cumsum, K4, and one gather of the sorted build
    ids masked to the exact total. Returns (r_ids, s_ids, total) with
    [capacity] int32 id columns, -1 from the total on, and ``total`` a
    0-d int64 tensor; past ``capacity`` the columns are cut."""
    total = cnt.sum(dtype=torch.int64)
    k_cap = min(capacity, cnt.shape[0])
    lo_c, cnt_c, sid_c = compact3(lo, cnt, ppid, k_cap)
    # int64 sum, clamped to the capacity: no slot reads a run past it, and
    # an oversized total must not wrap an int32 offset
    offs = torch.cumsum(cnt_c, 0, dtype=torch.int64) - cnt_c
    offs_c = offs.clamp_(max=capacity).to(torch.int32)
    bpos, sid_out = expand(offs_c, lo_c, sid_c, capacity)
    valid = torch.arange(capacity, device=cnt.device) < total
    bpos = bpos.clamp(0, sid_sorted.shape[0] - 1).long()
    r_ids = torch.where(valid, sid_sorted[bpos], -1)
    s_ids = torch.where(valid, sid_out, -1)
    return r_ids, s_ids, total


def _probe_sorted(sk, sid, pk, pid, capacity: int):
    """Probe pre-sorted build rows at a fixed result capacity: sort the
    probe rows, K2, then the local materialize. Returns (r_ids, s_ids,
    total)."""
    _, ppid, lo, cnt = _count_sorted(sk, pk, pid)
    return _materialize_counted(sid, ppid, lo, cnt, capacity)


def _local_join(bk, bid, pk, pid, capacity: int):
    """The equi-join of one shard's received rows at a fixed result
    capacity (the skew program's entry, whose buffers arrive unsorted)."""
    sk, sid = _sort_build(bk, bid)
    return _probe_sorted(sk, sid, pk, pid, capacity)


# ---- program stages (every held shard) ----

def _splitters(mesh: Mesh, samples: list):
    """P - 1 global splitter keys from every shard's samples, gathered and
    sorted: the same on every shard (one tensor)."""
    g = torch.sort(mesh.all_gather(samples)[0]).values
    step = g.shape[0] // mesh.size
    idx = torch.arange(1, mesh.size, device=g.device) * step
    return g[idx]


def _sorted_splitters(mesh: Mesh, r_keys, r_ids, s_keys, s_ids):
    """Sort every shard's tables and agree the splitters: (rs, ss, spl)
    with rs, ss lists of sorted (keys, ids) a shard."""
    rs = [_sort2(k, i, BUILD_PAD_KEY) for k, i in zip(r_keys, r_ids)]
    ss = [_sort2(k, i, PROBE_PAD_KEY) for k, i in zip(s_keys, s_ids)]
    spl = _splitters(mesh, [
        torch.cat([_quantile_sample(rk, SAMPLE_K),
                   _quantile_sample(sk, SAMPLE_K)])
        for (rk, _), (sk, _) in zip(rs, ss)])
    return rs, ss, spl


def _exchange_sorted(mesh: Mesh, sorted_side, spl, capacity: int,
                     pad_key: int):
    """Pack each shard's sorted rows by splitter bucket and exchange them.
    Returns (received keys, received ids, largest segment) a shard, the
    received columns flat [P * capacity]."""
    packed = [_pack_sorted(k, i, *_segment_bounds(k, spl, _n_real(i)),
                           capacity, pad_key) for k, i in sorted_side]
    rk = mesh.all_to_all([p[0] for p in packed])
    ri = mesh.all_to_all([p[1] for p in packed])
    return ([k.view(-1) for k in rk], [i.view(-1) for i in ri],
            [p[2] for p in packed])


def _telemetry(mesh: Mesh, *per_shard):
    """The mesh-wide max of each per-shard 0-d count, as an int64 [len]
    tensor the same on every shard."""
    return mesh.all_reduce(
        [torch.stack([v[d].long() for v in per_shard])
         for d in range(len(mesh.shards))], "max")


def _exchange_both(mesh: Mesh, rs, ss, spl, send_cap_r: int,
                   send_cap_s: int):
    """Exchange both sorted sides: ([(build keys, build ids, probe keys,
    probe ids)] received a held shard, [largest build segment], [largest
    probe segment])."""
    rbk, rbi, r_max = _exchange_sorted(mesh, rs, spl, send_cap_r,
                                       BUILD_PAD_KEY)
    sbk, sbi, s_max = _exchange_sorted(mesh, ss, spl, send_cap_s,
                                       PROBE_PAD_KEY)
    return list(zip(rbk, rbi, sbk, sbi)), r_max, s_max


def _join_presorted(mesh: Mesh, rs, ss, spl, send_cap_r: int,
                    send_cap_s: int, local_result_cap: int):
    received, r_max, s_max = _exchange_both(mesh, rs, ss, spl, send_cap_r,
                                            send_cap_s)
    outs = [_local_join(*cols, local_result_cap) for cols in received]
    totals = [o[2] for o in outs]
    ovf = _telemetry(mesh, r_max, s_max, totals)
    return ([o[0] for o in outs], [o[1] for o in outs],
            [t.view(1) for t in totals], ovf)


def make_splitter_stats_fn(mesh: Mesh):
    """The capacity pre-pass: sort each shard, agree the splitters, and
    report the exact largest segment a side over the mesh, so that the
    driver sizes the send buffers from counts rather than a slack factor.
    The sorted shards and splitters feed
    :func:`make_shuffle_join_presorted_fn`; nothing is sorted twice.

    Returns fn(r_keys, r_ids, s_keys, s_ids) -> (rk_s, ri_s, sk_s, si_s,
    spl, maxes): lists a held shard for the sorted columns, and the
    splitters and maxes = [largest build segment, largest probe segment]
    (int64), the same on every shard."""
    def step(r_keys, r_ids, s_keys, s_ids):
        rs, ss, spl = _sorted_splitters(mesh, r_keys, r_ids, s_keys, s_ids)
        seg = [[_segment_bounds(k, spl, _n_real(i))[1].max()
                for k, i in side] for side in (rs, ss)]
        maxes = _telemetry(mesh, *seg)
        return ([k for k, _ in rs], [i for _, i in rs], [k for k, _ in ss],
                [i for _, i in ss], spl, maxes)
    return step


def make_shuffle_join_presorted_fn(mesh: Mesh, send_cap_r: int,
                                   send_cap_s: int, local_result_cap: int):
    """The exchange and join on pre-sorted shards and agreed splitters
    (:func:`make_splitter_stats_fn`'s outputs). Same results and telemetry
    as :func:`make_shuffle_join_fn`."""
    def step(rk_s, ri_s, sk_s, si_s, spl):
        return _join_presorted(mesh, list(zip(rk_s, ri_s)),
                               list(zip(sk_s, si_s)), spl, send_cap_r,
                               send_cap_s, local_result_cap)
    return step


def make_shuffle_join_fn(mesh: Mesh, send_cap_r: int, send_cap_s: int,
                         local_result_cap: int):
    """The distributed join step at fixed capacities. Returns fn(r_keys,
    r_ids, s_keys, s_ids), each a list of one row shard a held shard, ->
    (r_out, s_out, totals, ovf): a held shard's [local_result_cap] id
    columns (-1 past its total) and its exact total ([1] int64), and the
    telemetry [largest build segment, largest probe segment, largest
    shard total] (int64, the same on every shard). A value of ovf above
    its capacity means that capacity overflowed."""
    def step(r_keys, r_ids, s_keys, s_ids):
        rs, ss, spl = _sorted_splitters(mesh, r_keys, r_ids, s_keys, s_ids)
        return _join_presorted(mesh, rs, ss, spl, send_cap_r, send_cap_s,
                               local_result_cap)
    return step


def make_shuffle_join_pipelined_fn(mesh: Mesh, send_cap_r: int,
                                   send_cap_s: int, chunk_result_cap: int,
                                   num_chunks: int = 2):
    """The pipelined step: the probe side is exchanged in ``num_chunks``
    slices, and chunk c + 1's exchange is issued before chunk c's local
    join, so on a process group (``async_op``) the exchange runs while
    the join computes. The build side is exchanged and sorted once first;
    the splitters come from the sorted build quantiles and a strided
    sample of the unsorted probe shard, so every chunk shares one
    co-partition.

    Local probe shards must split into ``num_chunks`` (the driver pads).
    Returns (r_out, s_out, totals, ovf): a held shard's chunks' results
    one after another ([num_chunks * chunk_result_cap]), its per-chunk
    totals ([num_chunks] int64), and the telemetry [build segment, probe
    segment, largest chunk total]."""
    def step(r_keys, r_ids, s_keys, s_ids):
        rs = [_sort2(k, i, BUILD_PAD_KEY) for k, i in zip(r_keys, r_ids)]
        spl = _splitters(mesh, [
            torch.cat([_quantile_sample(rk, SAMPLE_K), _quantile_sample(
                torch.where(si < 0, PROBE_PAD_KEY, sk), SAMPLE_K)])
            for (rk, _), sk, si in zip(rs, s_keys, s_ids)])
        rbk, rbi, r_max = _exchange_sorted(mesh, rs, spl, send_cap_r,
                                           BUILD_PAD_KEY)
        builds = [_sort_build(k, i) for k, i in zip(rbk, rbi)]

        def pack(keys, ids):
            ck, ci = _sort2(keys, ids, PROBE_PAD_KEY)
            return _pack_sorted(ck, ci, *_segment_bounds(ck, spl,
                                                         _n_real(ci)),
                                send_cap_s, PROBE_PAD_KEY)

        chunk = s_keys[0].shape[0] // num_chunks
        parts = [slice(c * chunk, (c + 1) * chunk) for c in range(num_chunks)]
        sends = [[pack(sk[part], si[part]) for sk, si in zip(s_keys, s_ids)]
                 for part in parts]
        s_max = [torch.stack([chunk_sends[d][2] for chunk_sends in sends])
                 .max() for d in range(len(s_keys))]

        def issue(c):
            return (mesh.all_to_all([p[0] for p in sends[c]], async_op=True),
                    mesh.all_to_all([p[1] for p in sends[c]], async_op=True))

        # software pipeline: exchange c + 1 is in flight while chunk c joins
        pending = [issue(0)] + [None] * (num_chunks - 1)
        outs = [[] for _ in s_keys]
        for c in range(num_chunks):
            if c + 1 < num_chunks:
                pending[c + 1] = issue(c + 1)
            pk, pi = (h.wait() for h in pending[c])
            pending[c] = None
            for d, (sk, sid) in enumerate(builds):
                outs[d].append(_probe_sorted(sk, sid, pk[d].view(-1),
                                             pi[d].view(-1),
                                             chunk_result_cap))
        totals = [torch.stack([o[2] for o in out]) for out in outs]
        ovf = _telemetry(mesh, r_max, s_max, [t.max() for t in totals])
        return ([torch.cat([o[0] for o in out]) for out in outs],
                [torch.cat([o[1] for o in out]) for out in outs], totals,
                ovf)
    return step


def make_shuffle_join_rle_fn(mesh: Mesh, send_cap_r: int, send_cap_s: int):
    """The factorized (RLE) step: each shard's local join in run-length
    form, (probe id, lo, cnt) per received probe row over its sorted build
    ids, where a materialized result would fit no fixed capacity.

    Returns fn(...) -> (ppid, lo, cnt, build_ids, pairs, ovf): a held
    shard's RLE columns (zero-count rows included: they expand to
    nothing), its sorted build ids, its exact pair count ([1] int64), and
    the send telemetry [build segment, probe segment]."""
    def step(r_keys, r_ids, s_keys, s_ids):
        received, r_max, s_max = _exchange_both(
            mesh, *_sorted_splitters(mesh, r_keys, r_ids, s_keys, s_ids),
            send_cap_r, send_cap_s)
        cols = []
        for bk, bi, pk, pi in received:
            sk, sid = _sort_build(bk, bi)
            _, ppid, lo, cnt = _count_sorted(sk, pk, pi)
            cols.append((ppid, lo, cnt, sid,
                         cnt.sum(dtype=torch.int64).view(1)))
        ovf = _telemetry(mesh, r_max, s_max)
        return (*([c[j] for c in cols] for j in range(5)), ovf)
    return step


def make_shuffle_semi_fn(mesh: Mesh, send_cap_r: int, send_cap_s: int):
    """The semi/anti step, count phase only: after the exchange, each
    shard gives (probe id, matched) for every received probe row. No
    result capacity exists to overflow; only the send buffers report.
    Returns fn(...) -> (ppid, matched, ovf) with ``matched`` int32 0/1."""
    def step(r_keys, r_ids, s_keys, s_ids):
        received, r_max, s_max = _exchange_both(
            mesh, *_sorted_splitters(mesh, r_keys, r_ids, s_keys, s_ids),
            send_cap_r, send_cap_s)
        ppid, matched = [], []
        for bk, bi, pk, pi in received:
            sk, _ = _sort_build(bk, bi)
            _, pp, _, cnt = _count_sorted(sk, pk, pi)
            ppid.append(pp)
            matched.append((cnt > 0).to(torch.int32))
        return ppid, matched, _telemetry(mesh, r_max, s_max)
    return step


# ---- drivers ----

def _pad_sharded(keys: torch.Tensor, ids: torch.Tensor, mult: int):
    """Pad (keys, ids) to a multiple of ``mult`` rows, at least one
    (pad keys 0, pad ids -1)."""
    pad = round_up(max(keys.shape[0], 1), mult) - keys.shape[0]
    if not pad:
        return keys, ids
    return (torch.cat([keys, keys.new_zeros(pad)]),
            torch.cat([ids, ids.new_full((pad,), -1)]))


def _sharded_inputs(mesh: Mesh, r_keys, s_keys, chunks: int = 1):
    """Both tables with global row ids, padded where they lie (the build
    side to a multiple of P rows, the probe side of P x ``chunks``) and
    row-sharded: (rk, ri, sk, si), lists a held shard on the mesh's
    device (a process moves only its own shards' rows)."""
    out = []
    for keys, mult in ((r_keys, mesh.size), (s_keys, mesh.size * chunks)):
        keys = torch.as_tensor(keys, dtype=torch.int32)
        ids = torch.arange(keys.shape[0], dtype=torch.int32,
                           device=keys.device)
        out += [mesh.put_rows(x) for x in _pad_sharded(keys, ids, mult)]
    return out


def _mesh_for(mesh, device, *keys) -> Mesh:
    """``mesh``, else the default mesh on ``device``, else on the keys'
    device (CUDA for numpy keys)."""
    if mesh is not None:
        return mesh
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        device = resolve_device(*keys, device=device)
    return make_mesh(device=device)


def _balanced_cap(rows_padded: int, parts: int, peers: int,
                  slack: float) -> int:
    """``slack`` x one shard's balanced share to one peer, + 64, rounded."""
    return round_up(int(cdiv(rows_padded // parts, peers) * slack) + 64,
                    CAP_GRANULE)


def _gather(mesh: Mesh, cols: list) -> torch.Tensor:
    """Every shard's fixed-size column, in shard order, as one [P, len]
    tensor on the mesh's device (on every process)."""
    return mesh.all_gather([c.reshape(-1) for c in cols])[0].view(
        mesh.size, -1)


def _trimmed(mesh: Mesh, cols: list, totals: list) -> np.ndarray:
    """The pairs of every shard (or chunk): each padded block cut to its
    total on the device, the blocks in shard order, as numpy."""
    tot = _gather(mesh, totals).view(-1).tolist()
    rows = _gather(mesh, cols).view(len(tot), -1)
    return torch.cat([rows[b, :t] for b, t in enumerate(tot)]).cpu().numpy()


def _send_capped(make_fn, r_keys, s_keys, mesh, slack: float,
                 max_retries: int, device, what: str):
    """Run a step whose only capacities are the send buffers (slack x the
    balanced share, then the reported maxima) until nothing overflows.
    Returns (mesh, the step's outputs)."""
    mesh = _mesh_for(mesh, device, r_keys, s_keys)
    p = mesh.size
    rk, ri, sk, si = _sharded_inputs(mesh, r_keys, s_keys)
    cap_r = _balanced_cap(rk[0].shape[0] * p, p, p, slack)
    cap_s = _balanced_cap(sk[0].shape[0] * p, p, p, slack)
    for _ in range(max_retries):
        out = make_fn(mesh, cap_r, cap_s)(rk, ri, sk, si)
        ovf = out[-1].tolist()
        if ovf[0] <= cap_r and ovf[1] <= cap_s:
            return mesh, out
        cap_r = max(cap_r, round_up(ovf[0], CAP_GRANULE))
        cap_s = max(cap_s, round_up(ovf[1], CAP_GRANULE))
    raise RuntimeError(f"{what} send caps did not converge: {ovf}")


def distributed_hash_join_rle(r_keys, s_keys, *, mesh: Mesh | None = None,
                              slack: float = 1.25, max_retries: int = 3,
                              device: torch.device | str | None = None):
    """Driver: the distributed join in factorized (RLE) form, the scale-out
    path for joins whose pairs fit no result buffer.

    Returns (shards, total_pairs): ``shards`` a list of one dict a shard
    {probe_ids, lo, cnt, build_ids} (numpy; run r of shard d expands to
    the pairs (build_ids[lo[r] + j], probe_ids[r]) for j < cnt[r]),
    ``total_pairs`` the exact global pair count (a Python int, not bound
    by int32)."""
    mesh, (ppid, lo, cnt, bid, pairs, _) = _send_capped(
        make_shuffle_join_rle_fn, r_keys, s_keys, mesh, slack, max_retries,
        device, "RLE shuffle join")
    cols = [_gather(mesh, c).cpu().numpy() for c in (ppid, lo, cnt, bid)]
    shards = [{"probe_ids": cols[0][d], "lo": cols[1][d], "cnt": cols[2][d],
               "build_ids": cols[3][d]} for d in range(mesh.size)]
    return shards, int(mesh.all_reduce(pairs, "sum"))


def _distributed_match_ids(r_keys, s_keys, mesh, slack, max_retries,
                           device):
    """(probe ids, matched) of every real received probe row, numpy."""
    mesh, (ppid, matched, _) = _send_capped(
        make_shuffle_semi_fn, r_keys, s_keys, mesh, slack, max_retries,
        device, "semi join")
    ppid = _gather(mesh, ppid).view(-1)
    valid = ppid >= 0
    return (ppid[valid].cpu().numpy(),
            (_gather(mesh, matched).view(-1)[valid] > 0).cpu().numpy())


def distributed_semi_join(r_keys, s_keys, *, mesh: Mesh | None = None,
                          slack: float = 1.25, max_retries: int = 3,
                          device: torch.device | str | None = None):
    """Probe-side distributed semi join: the sorted global ids of the s
    rows with at least one match in r (numpy int32), as
    ops.merge_join.semi_join gives them."""
    ids, matched = _distributed_match_ids(r_keys, s_keys, mesh, slack,
                                          max_retries, device)
    return np.sort(ids[matched])


def distributed_anti_join(r_keys, s_keys, *, mesh: Mesh | None = None,
                          slack: float = 1.25, max_retries: int = 3,
                          device: torch.device | str | None = None):
    """Probe-side distributed anti join: the sorted global ids of the s
    rows with no match in r (numpy int32)."""
    ids, matched = _distributed_match_ids(r_keys, s_keys, mesh, slack,
                                          max_retries, device)
    return np.sort(ids[~matched])


def recommended_slack(distribution: str = "uniform") -> float:
    """The send-segment slack over the balanced share n_local / P:
    splitter sampling balances rows to ~1% on uniform keys; Zipf keys keep
    headroom, since a heavy key is never split by a range partition (the
    skew path replicates it). The drivers' retry covers the tail."""
    return 1.25 if distribution == "uniform" else 4.0


def distributed_hash_join(r_keys, s_keys, *, mesh: Mesh | None = None,
                          slack: float = 1.25,
                          expected_matches: int | None = None,
                          max_retries: int = 3, skew: bool = False,
                          pipeline_chunks: int = 1,
                          compact_step: int | None = None,
                          auto_caps: bool = True,
                          device: torch.device | str | None = None):
    """Driver: the exact distributed equi-join over the mesh (default:
    :func:`make_mesh` on ``device``, else the keys' device, else CUDA).

    ``skew=True`` takes the heavy-hitter split
    (:mod:`tpujoin_torch.parallel.skew`), for Zipf-like keys.
    ``pipeline_chunks > 1`` exchanges the probe side in that many slices,
    chunk c + 1's exchange in flight during chunk c's join.
    ``auto_caps`` (the unpipelined default) sizes the send buffers from
    the exact segment maxima of a splitter pre-pass; ``slack`` then sizes
    only the result buffer. ``compact_step`` is taken and has no effect:
    it chose the TPU compaction kernel's output width, and Hopper's K3
    compacts any input in one pass, with no coverage flag to fall back
    on.

    Pads both tables to a multiple of the mesh size (the probe side to P
    x ``pipeline_chunks``), row-shards them, runs the step, and retries
    with larger capacities on reported overflow. Returns (r_ids, s_ids),
    numpy int32 global row-id pairs on every process: the pairs of
    :func:`tpujoin_torch.merge_join` as a multiset."""
    del compact_step
    if skew:
        from tpujoin_torch.parallel.skew import distributed_hash_join_skew

        return distributed_hash_join_skew(
            r_keys, s_keys, mesh=mesh, slack=max(slack, 2.0),
            expected_matches=expected_matches, device=device)
    mesh = _mesh_for(mesh, device, r_keys, s_keys)
    p = mesh.size
    nchunks = max(pipeline_chunks, 1)
    n, m = len(r_keys), len(s_keys)
    rk, ri, sk, si = _sharded_inputs(mesh, r_keys, s_keys, nchunks)
    if expected_matches is None:
        expected_matches = max(n, m)
    use_auto = auto_caps and nchunks == 1
    if use_auto:
        rk_s, ri_s, sk_s, si_s, spl, maxes = make_splitter_stats_fn(mesh)(
            rk, ri, sk, si)
        cap_r, cap_s = (round_up(v + 64, CAP_GRANULE)
                        for v in maxes.tolist())
    else:
        cap_r = _balanced_cap(rk[0].shape[0] * p, p, p, slack)
        cap_s = _balanced_cap(sk[0].shape[0] * p, p * nchunks, p, slack)
    cap_res = round_up(int(expected_matches / (p * nchunks) * slack) + 64,
                       CAP_GRANULE)

    retries = max_retries
    while True:
        if nchunks > 1:
            r_out, s_out, totals, ovf = make_shuffle_join_pipelined_fn(
                mesh, cap_r, cap_s, cap_res, nchunks)(rk, ri, sk, si)
        elif use_auto:
            r_out, s_out, totals, ovf = make_shuffle_join_presorted_fn(
                mesh, cap_r, cap_s, cap_res)(rk_s, ri_s, sk_s, si_s, spl)
        else:
            r_out, s_out, totals, ovf = make_shuffle_join_fn(
                mesh, cap_r, cap_s, cap_res)(rk, ri, sk, si)
        ovf = ovf.tolist()
        if ovf[0] <= cap_r and ovf[1] <= cap_s and ovf[2] <= cap_res:
            break
        if retries == 0:
            raise RuntimeError(f"shuffle join capacities did not converge: "
                               f"{ovf}")
        retries -= 1
        cap_r = max(cap_r, round_up(ovf[0], CAP_GRANULE))
        cap_s = max(cap_s, round_up(ovf[1], CAP_GRANULE))
        cap_res = max(cap_res, round_up(ovf[2], CAP_GRANULE))
    return _trimmed(mesh, r_out, totals), _trimmed(mesh, s_out, totals)
