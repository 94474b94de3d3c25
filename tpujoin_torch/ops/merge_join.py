"""Sort-merge probe pipeline, the v2 engine (the port of
tpujoin/ops/merge_join.py).

  count:       sort the probe keys with their row ids (K1, whose first
               pass makes the ids) -> merge_count (K2)
  RLE result:  the rows with matches, compacted (K3, or the identity when
               every probe row matched): (probe id, lo, cnt) per row
  materialize: that compaction -> cumsum -> the path plan_materialize picks
               from its ints, by duplication:
                 fill    group heads -> expand_fill (K5)
                 expand  expand_runs (K7b), its phases on the device clock
               probe_materialize_groups (K7, K5's kernel on the group
               heads) is an entry of its own, outside the planner.

Results come out in sorted-probe order; the join result is an unordered
multiset, checked as one by the oracle, so nothing is unsorted.

Spans (tpujoin_torch/trace.py), in the table's join: ``count`` holds
``count.sort`` (K1), ``count.merge`` (K2) and ``count.totals``, each
with device time; ``materialize`` holds ``materialize.<path>``, the path
taken, which holds ``compact`` (K3 or the identity), ``offsets`` (the
cumsum), ``group_heads`` (fill) and ``pairs`` (K5 or K7b). On the expand
path, which runs over every matched row and at volume paces the device,
``compact``, ``offsets`` and ``pairs`` have device time too; fill's
spans are on the host clock alone, since the host paces it and timing
events there would add to the device's idle time. Every host sync on
these paths is a ``sync.<site>`` span: the group heads'
``torch.nonzero`` and each blocking upload of a host number.

The semi, anti and left-outer joins run on the same count state: the
matched flag scattered into probe-id order, compacted by K6a
(``compact_ids``) on itself and on its complement, gives the matched and
the unmatched probe ids, each ascending, with no sort.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpujoin_torch import trace
from tpujoin_torch.kernels.compact import compact3, compact_ids
from tpujoin_torch.kernels.expand_fill import expand_fill
from tpujoin_torch.kernels.expand_groups import expand_groups
from tpujoin_torch.kernels.expand_runs import expand_runs
from tpujoin_torch.kernels.merge_count import merge_count
from tpujoin_torch.kernels.merge_sort import sort_rows
from tpujoin_torch.ops.hash_join import HashJoinTable, _i32_tensor, build
from tpujoin_torch.utils.device import i32_columns
from tpujoin_torch.utils.shapes import round_up

INT32_MAX = 0x7FFFFFFF

# Average matches per probe row from which plan_materialize takes the
# fill path (K5 on the group heads) when the capacities fit; below it, or
# when they do not, the expand path (K7b). The JAX planner's threshold.
GROUPS_MIN_DUP = 35


@dataclasses.dataclass
class SortedProbe:
    """Count-phase state, all in sorted-probe-key order."""

    probe_ids: torch.Tensor   # [m] original probe row ids under the sort
    lo: torch.Tensor          # [m] lower bound in the sorted build keys
    counts: torch.Tensor      # [m] match counts

    @classmethod
    def from_numpy(cls, probe_ids: np.ndarray, lo: np.ndarray,
                   counts: np.ndarray,
                   device: torch.device | str = "cpu") -> "SortedProbe":
        """State from another implementation (e.g. the JAX package's)."""
        return cls(_i32_tensor(probe_ids, device), _i32_tensor(lo, device),
                   _i32_tensor(counts, device))


def probe_count(ht: HashJoinTable, probe_keys: torch.Tensor):
    """Count phase. Returns (state, total, nonzero) with ``total`` the exact
    result size (0-d int64 tensor) and ``nonzero`` the number of probe rows
    with at least one match (0-d int64 tensor)."""
    pk = probe_keys
    with trace.span("count", pk, ht.trace_id):
        with trace.span("count.sort", pk):
            psk, pid = sort_rows(pk)
        with trace.span("count.merge", pk):
            lo, cnt = merge_count(ht.sorted_keys, psk)
        with trace.span("count.totals", pk):
            total = cnt.sum(dtype=torch.int64)
            nonzero = (cnt > 0).sum()
    return SortedProbe(pid, lo, cnt), total, nonzero


def _fit(col: torch.Tensor, k_cap: int) -> torch.Tensor:
    """``col`` cut or zero-padded to k_cap rows."""
    if k_cap <= col.shape[0]:
        return col[:k_cap]
    return torch.cat([col, col.new_zeros(k_cap - col.shape[0])])


def _compact(state: SortedProbe, k_cap: int, all_matched: bool = False,
             timed: bool = False):
    """Compact the count state to the rows with >= 1 match, at width k_cap
    with a zero tail. Returns (lo_c, cnt_c, sid_c, offs_c); offs_c is the
    exclusive cumsum of cnt_c (int32: a result slot is an i32).
    ``all_matched`` asserts nonzero == m (every probe row has a match, as on
    a fully covered key domain): compaction is then the identity and K3
    does not run. ``timed`` gives the spans device time."""
    on = state.counts if timed else None
    with trace.span("compact", on):
        if all_matched:
            lo_c, cnt_c, sid_c = (_fit(c, k_cap) for c in
                                  (state.lo, state.counts, state.probe_ids))
        else:
            lo_c, cnt_c, sid_c = compact3(state.lo, state.counts,
                                          state.probe_ids, k_cap)
    with trace.span("offsets", on):
        offs_c = torch.cumsum(cnt_c, 0, dtype=torch.int32) - cnt_c
    return lo_c, cnt_c, sid_c, offs_c


def _group_heads(lo_c, cnt_c, offs_c, k_cap: int, nonzero: int):
    """Group extraction: equal probe keys share one (lo, cnt) build range,
    and lo strictly increases across distinct matched keys, so the group
    heads are exactly the matched rows where lo changes. Returns
    (goff_h, glo_h, gnb_h, ngroups): the heads' offsets, build starts and
    build lengths in row order at width k_cap, goff_h INT32_MAX and
    glo_h, gnb_h 0 past the ``ngroups`` heads (an int)."""
    dev = lo_c.device
    with trace.span("group_heads"):
        row = torch.arange(k_cap, device=dev)
        prev_lo = torch.cat([lo_c[:1] - 1, lo_c[:-1]])
        is_head = (row < nonzero) & (lo_c != prev_lo)
        with trace.sync("group_heads"):
            heads = torch.nonzero(is_head).squeeze(1)
        ngroups = heads.shape[0]
        goff_h = torch.full((k_cap,), INT32_MAX, dtype=torch.int32,
                            device=dev)
        glo_h = torch.zeros(k_cap, dtype=torch.int32, device=dev)
        gnb_h = torch.zeros_like(glo_h)
        for out, col in ((goff_h, offs_c), (glo_h, lo_c), (gnb_h, cnt_c)):
            out[:ngroups] = col[heads]
    return goff_h, glo_h, gnb_h, ngroups


def _upload(x, dtype: torch.dtype, dev: torch.device, site: str):
    """``torch.as_tensor(x, dtype, dev)``: a blocking copy, and so a host
    sync (span ``sync.<site>``), unless x is a tensor on ``dev``."""
    if isinstance(x, torch.Tensor) and x.device == dev:
        return torch.as_tensor(x, dtype=dtype, device=dev)
    with trace.sync(site):
        return torch.as_tensor(x, dtype=dtype, device=dev)


def _checked(r_ids, s_ids, probe_base: int, total, nonzero, k_cap: int,
             capacity: int):
    """The probe_materialize_* return: (r_ids, s_ids + probe_base on the
    pair slots, total, fits) with ``total`` a 0-d int64 tensor and ``fits``
    a 0-d bool tensor, False when either capacity is too small (the output
    is then a truncated multiset)."""
    dev = r_ids.device
    if probe_base:
        s_ids = torch.where(s_ids >= 0, s_ids + probe_base, -1)
    total = _upload(total, torch.int64, dev, "checked.total")
    nonzero = _upload(nonzero, torch.int64, dev, "checked.nonzero")
    fits = (total <= capacity) & (nonzero <= k_cap)
    return r_ids, s_ids, total, fits


def probe_materialize(ht: HashJoinTable, state: SortedProbe, k_cap: int,
                      capacity: int, probe_base: int = 0, *, total: int,
                      nonzero: int):
    """Materialize phase of the expand path: K3, the cumsum and
    expand_runs (K7b), the pair columns straight from the compacted runs,
    at capacities k_cap >= nonzero rows and capacity >= total pairs, where
    ``total`` and ``nonzero`` are probe_count's, as ints. Returns (r_ids,
    s_ids, total, fits), each id column [capacity] int32 with -1 in the
    slots past the total. ``fits`` (0-d bool tensor) is False when either
    capacity is too small; the output is then a truncated multiset. Its
    phases have device time: at volume this path paces the device."""
    lo_c, _, sid_c, offs_c = _compact(state, k_cap, timed=True)
    with trace.span("pairs", offs_c):
        r_ids, s_ids = expand_runs(offs_c, lo_c, sid_c, ht.sorted_ids,
                                   min(nonzero, k_cap), total, capacity)
    return _checked(r_ids, s_ids, probe_base, total, nonzero, k_cap,
                    capacity)


def probe_materialize_groups(ht: HashJoinTable, state: SortedProbe,
                             k_cap: int, capacity: int, probe_base: int = 0,
                             *, total: int, nonzero: int):
    """Materialize phase on expand_groups (K7): the group heads of the
    compacted runs, then one periodic slice of the sorted build ids per
    group. Same contract as :func:`probe_materialize`. No planner path
    reaches it: it is K7's op, called directly."""
    lo_c, cnt_c, sid_c, offs_c = _compact(state, k_cap)
    goff, glo, gnb, ngroups = _group_heads(lo_c, cnt_c, offs_c, k_cap,
                                           nonzero)
    with trace.span("pairs"):
        r_ids, s_ids = expand_groups(offs_c, sid_c, goff, glo, gnb,
                                     ht.sorted_ids, min(nonzero, k_cap),
                                     ngroups, total, capacity)
    return _checked(r_ids, s_ids, probe_base, total, nonzero, k_cap,
                    capacity)


def probe_materialize_fill(ht: HashJoinTable, state: SortedProbe, k_cap: int,
                           capacity: int, probe_base: int = 0,
                           all_matched: bool = False, *, total: int,
                           nonzero: int):
    """Materialize phase on expand_fill (K5), the path of high-duplication
    joins: the group heads of the compacted runs, then each slot's pair
    from its run's probe id and its group's periodic build slice.
    ``all_matched`` asserts nonzero == m and skips compaction (see
    :func:`_compact`). Same contract as :func:`probe_materialize`."""
    lo_c, cnt_c, sid_c, offs_c = _compact(state, k_cap, all_matched)
    goff, glo, gnb, ngroups = _group_heads(lo_c, cnt_c, offs_c, k_cap,
                                           nonzero)
    with trace.span("pairs"):
        r_ids, s_ids = expand_fill(offs_c, sid_c, goff, glo, gnb,
                                   ht.sorted_ids, min(nonzero, k_cap),
                                   ngroups, total, capacity)
    return _checked(r_ids, s_ids, probe_base, total, nonzero, k_cap,
                    capacity)


def probe_rle(state: SortedProbe, k_cap: int, all_matched: bool = False):
    """Factorized (RLE) result at row capacity k_cap: per matched probe
    row, (probe_id, lo, cnt) over the build table's ``sorted_ids``,
    zero-padded. This is
    the join result in run-length form (total pairs = sum(cnt)), without
    the pair expansion. ``all_matched`` as in :func:`_compact`."""
    lo_c, cnt_c, sid_c, _ = _compact(state, k_cap, all_matched)
    return sid_c, lo_c, cnt_c


def merge_join_rle(build_keys, probe_keys, *,
                   device: torch.device | str | None = None,
                   row_pad_multiple: int = 1 << 16):
    """Full join returning the factorized result as numpy int32 arrays
    (probe_ids, lo, cnt, sorted_build_ids) with an exact row count: row r
    expands to the pairs (sorted_build_ids[lo[r] + j], probe_ids[r]) for
    j < cnt[r]. Keys are numpy arrays or tensors; ``device`` defaults to
    the tensors' device, else CUDA."""
    bk, pk = i32_columns(build_keys, probe_keys, device=device)
    ht = build(bk)
    state, _, nonzero = probe_count(ht, pk)
    nonzero = int(nonzero)
    src = ht.sorted_ids.cpu().numpy()
    if nonzero == 0:
        e = np.empty(0, np.int32)
        return e, e, e, src
    k_cap = round_up(nonzero, row_pad_multiple)
    cols = probe_rle(state, k_cap, all_matched=nonzero == pk.shape[0])
    return (*(c[:nonzero].cpu().numpy() for c in cols), src)


def _match_partition(state: SortedProbe, nonzero: int) -> torch.Tensor:
    """[m] int32: the ``nonzero`` matched probe ids ascending, then the
    unmatched ones ascending."""
    m = state.counts.shape[0]
    matched = torch.zeros(m, dtype=torch.bool, device=state.counts.device)
    matched[state.probe_ids.long()] = state.counts > 0
    parts = [compact_ids(mask, k)[0]
             for mask, k in ((matched, nonzero), (~matched, m - nonzero))
             if k]
    return torch.cat(parts) if parts else state.probe_ids[:0]


def _partition(build_keys, probe_keys, device):
    """(ht, state, total, nonzero, partition) of one join, where total and
    nonzero are ints and partition is :func:`_match_partition`'s."""
    bk, pk = i32_columns(build_keys, probe_keys, device=device)
    ht = build(bk)
    state, total, nonzero = probe_count(ht, pk)
    nonzero = int(nonzero)
    return ht, state, int(total), nonzero, _match_partition(state, nonzero)


def semi_join(build_keys, probe_keys, *,
              device: torch.device | str | None = None, **_ignored):
    """Probe-side semi join: the ids of the probe rows with at least one
    build match, ascending, as a numpy int32 array. Keys and ``device`` as
    in :func:`merge_join`; other keywords (``row_pad_multiple``) are taken
    and ignored, as by the JAX package."""
    *_, nonzero, part = _partition(build_keys, probe_keys, device)
    return part[:nonzero].cpu().numpy()


def anti_join(build_keys, probe_keys, *,
              device: torch.device | str | None = None, **_ignored):
    """Probe-side anti join: the ids of the probe rows with no build
    match, ascending, as a numpy int32 array."""
    *_, nonzero, part = _partition(build_keys, probe_keys, device)
    return part[nonzero:].cpu().numpy()


def left_outer_join(build_keys, probe_keys, *,
                    device: torch.device | str | None = None,
                    result_pad_multiple: int = 1 << 20, **_ignored):
    """Probe-side left outer join as numpy int32 arrays (r_ids, s_ids):
    every inner pair (on :func:`probe_materialize`), then (-1, id) for each
    unmatched probe row, ascending. One count and one materialize."""
    ht, state, total, nonzero, part = _partition(build_keys, probe_keys,
                                                 device)
    unmatched = part[nonzero:].cpu().numpy()
    r_inner = s_inner = np.empty(0, np.int32)
    if total:
        k_cap, cap = capacities(total, nonzero, result_pad_multiple)
        r_ids, s_ids, _, fits = probe_materialize(
            ht, state, k_cap, cap, total=total, nonzero=nonzero)
        if not bool(fits):
            raise RuntimeError("materialize capacity undersized")
        r_inner = r_ids[:total].cpu().numpy()
        s_inner = s_ids[:total].cpu().numpy()
    return (np.concatenate([r_inner, np.full(len(unmatched), -1, np.int32)]),
            np.concatenate([s_inner, unmatched]))


def capacities(total: int, nonzero: int,
               result_pad_multiple: int) -> tuple[int, int]:
    """(k_cap, capacity) of a join with ``total`` pairs over ``nonzero``
    matched probe rows: the rows rounded up to max(pad // 8, 1024) and the
    pairs to the pad, so plan_materialize's ``fits`` holds."""
    return (round_up(nonzero, max(result_pad_multiple // 8, 1024)),
            round_up(total, result_pad_multiple))


def plan_materialize(ht: HashJoinTable, state: SortedProbe, k_cap: int,
                     capacity: int, *, total: int, nonzero: int,
                     probe_base: int = 0):
    """The materialize path for this workload, as (name, results, replay):
    ``results`` is the path's (r_ids, s_ids, total) already computed and
    ``replay()`` runs the same call again. One decision on the host ints:
    fill from GROUPS_MIN_DUP average matches a row when both capacities
    fit, else expand, whose ``fits`` is then False when they do not. Spans
    ``materialize`` and, within it, ``materialize.<path>``, in the table's
    join."""
    fits = total <= capacity and nonzero <= k_cap
    if fits and total >= nonzero * GROUPS_MIN_DUP:
        name, fn = "fill", functools.partial(
            probe_materialize_fill,
            all_matched=nonzero == state.counts.shape[0])
    else:
        name, fn = "expand", probe_materialize

    def replay():
        return fn(ht, state, k_cap, capacity, probe_base, total=total,
                  nonzero=nonzero)[:3]

    with trace.span("materialize", join=ht.trace_id):
        with trace.span("materialize." + name):
            return name, replay(), replay


def merge_join(build_keys, probe_keys, *,
               device: torch.device | str | None = None,
               probe_chunk_rows: int | None = None,
               result_pad_multiple: int = 1 << 20):
    """Full join on the v2 pipeline: all (rowID_R, rowID_S) pairs with
    equal keys, as exact-size numpy int32 arrays. Keys are numpy arrays or
    tensors; ``device`` defaults to the tensors' device, else CUDA (there
    is no silent CPU fallback: pass ``device="cpu"`` for the plain
    versions). The probe side runs in chunks of ``probe_chunk_rows`` (all
    at once when None), the last one at its own length."""
    bk, pk = i32_columns(build_keys, probe_keys, device=device)
    m = pk.shape[0]
    chunk = m if probe_chunk_rows is None else min(probe_chunk_rows, max(m, 1))

    ht = build(bk)
    out_r, out_s = [], []
    for start in range(0, m, chunk) if m else []:
        state, total, nonzero = probe_count(ht, pk[start:start + chunk])
        total, nonzero = int(total), int(nonzero)
        if total == 0:
            continue
        k_cap, cap = capacities(total, nonzero, result_pad_multiple)
        _, (r_ids, s_ids, _), _ = plan_materialize(
            ht, state, k_cap, cap, total=total, nonzero=nonzero,
            probe_base=start)
        out_r.append(r_ids[:total].cpu().numpy())
        out_s.append(s_ids[:total].cpu().numpy())

    if not out_r:
        return np.empty((0,), np.int32), np.empty((0,), np.int32)
    return np.concatenate(out_r), np.concatenate(out_s)
