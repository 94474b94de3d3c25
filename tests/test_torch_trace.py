"""tpujoin_torch.trace on the CPU: spans record nothing without a profiler;
under one, a v2 join gives its named span tree in one join, marks every
host sync of its path and shows in the profiler's events; the record
deque stays bounded; the CPU path launches no kernel."""
import numpy as np
import pytest
import torch

from tpujoin_torch import trace
from tpujoin_torch.kernels import _build
from tpujoin_torch.ops import hash_join, merge_join
from tpujoin_torch.utils.shapes import round_up

CPU = [torch.profiler.ProfilerActivity.CPU]

EXPAND_SYNCS = ["sync.checked.total", "sync.checked.nonzero"]
# case -> (key domain, the path the planner takes, the sync records of its
# materialize, in order); expand.dup10 has ~10 matches a row
PATHS = {"expand": (10**6, "expand", EXPAND_SYNCS),
         "expand.dup10": (300, "expand", EXPAND_SYNCS),
         "fill": (40, "fill", ["sync.group_heads", *EXPAND_SYNCS])}

# each span's parent
PARENTS = {"build": None, "build.sort": "build",
           "count": None, "count.sort": "count",
           "count.merge": "count", "count.totals": "count",
           "materialize": None, "compact": "materialize.{path}",
           "offsets": "materialize.{path}", "pairs": "materialize.{path}",
           "materialize.{path}": "materialize",
           "group_heads": "materialize.{path}",
           "sync.group_heads": "group_heads",
           "sync.checked.total": "materialize.{path}",
           "sync.checked.nonzero": "materialize.{path}"}


def _keys(dom: int):
    rng = np.random.default_rng(dom)
    return (torch.from_numpy(rng.integers(1, dom + 1, 3000).astype(np.int32)),
            torch.from_numpy(rng.integers(1, dom + 1, 2500).astype(np.int32)))


def _join(dom: int) -> str:
    """One v2 join on the CPU, as the benchmark runs it; its path."""
    bk, pk = _keys(dom)
    ht = hash_join.build(bk)
    state, total, nonzero = merge_join.probe_count(ht, pk)
    total, nonzero = int(total), int(nonzero)
    return merge_join.plan_materialize(
        ht, state, round_up(nonzero, 1024), round_up(total, 1024),
        total=total, nonzero=nonzero)[0]


def _spans():
    return [r for r in trace.records() if r["kind"] != "setup"]


def test_off_records_nothing_and_spans_are_the_shared_no_op():
    trace.clear()
    assert _join(40) == "fill"
    assert _spans() == []
    assert trace.span("build") is trace.OFF
    assert trace.sync("group_heads") is trace.OFF
    assert trace.new_join() == -1
    assert hash_join.build(_keys(40)[0]).trace_id == -1


@pytest.mark.parametrize("case", sorted(PATHS))
def test_a_join_gives_its_span_tree(case):
    dom, path, syncs = PATHS[case]
    trace.clear()
    with torch.profiler.profile(activities=CPU) as prof:
        assert _join(dom) == path
    recs = _spans()
    parents = {k.format(path=path): v and v.format(path=path)
               for k, v in PARENTS.items()}
    want = {"build", "build.sort", "count", "count.sort", "count.merge",
            "count.totals", "materialize",
            f"materialize.{path}", "compact", "offsets", "pairs", *syncs}
    if path == "fill":
        want.add("group_heads")
    assert {r["name"] for r in recs} == want
    for r in recs:
        assert r["parent"] == parents[r["name"]], r
        assert r["device_ms"] is None and r["host_ms"] >= 0
    assert len({r["join"] for r in recs}) == 1 and recs[0]["join"] >= 0
    assert [r["name"] for r in recs if r["kind"] == "sync"] == syncs
    assert all(r["kind"] == "span" for r in recs
               if not r["name"].startswith("sync."))
    names = {e.name for e in prof.events()}
    assert {trace.PREFIX + n for n in want} <= names


def test_joins_take_new_ids_and_children_inherit_them():
    trace.clear()
    with torch.profiler.profile(activities=CPU):
        a, b = (hash_join.build(_keys(40)[0]) for _ in range(2))
        with trace.span("outer", join=b.trace_id):
            with trace.span("inner"):
                pass
            with trace.span("other", join=a.trace_id):
                pass
    assert b.trace_id == a.trace_id + 1
    joins = {r["name"]: r["join"] for r in _spans()}
    assert joins["inner"] == joins["outer"] == b.trace_id
    assert joins["other"] == a.trace_id


def test_an_upload_of_a_tensor_on_the_device_is_no_sync():
    trace.clear()
    dev = torch.device("cpu")
    with torch.profiler.profile(activities=CPU):
        merge_join._upload(torch.tensor(5), torch.int64, dev, "t")
        merge_join._upload(5, torch.int64, dev, "n")
    assert [r["name"] for r in _spans()] == ["sync.n"]


@pytest.mark.parametrize("cut", ["capacity", "k_cap"])
@pytest.mark.parametrize("case", ["expand", "fill"])
def test_undersized_capacities_run_expand_once(monkeypatch, case, cut):
    """plan_materialize with the pair or the row capacity one short runs
    one path, expand, once: one ``materialize.<path>`` span, no
    ``sync.fits``, one ``fits``, False. With the pairs one short, the
    slots it writes are distinct pairs of equal keys: a sub-multiset of
    the join's (truncated rows promise no pairs)."""
    bk, pk = _keys(PATHS[case][0])
    ht = hash_join.build(bk)
    state, total, nonzero = merge_join.probe_count(ht, pk)
    total, nonzero = int(total), int(nonzero)
    k_cap, cap = (nonzero, total - 1) if cut == "capacity" else (
        nonzero - 1, total)
    checked, real = [], merge_join._checked

    def spy(*args):
        checked.append(real(*args))
        return checked[-1]
    monkeypatch.setattr(merge_join, "_checked", spy)
    trace.clear()
    with torch.profiler.profile(activities=CPU):
        name, (r, s, tot), _ = merge_join.plan_materialize(
            ht, state, k_cap, cap, total=total, nonzero=nonzero)
    names = [x["name"] for x in _spans()]
    assert name == "expand" and int(tot) == total
    assert [n for n in names if n.startswith("materialize.")] == \
        ["materialize.expand"]
    assert "sync.fits" not in names
    assert len(checked) == 1 and not bool(checked[0][3])
    if cut == "capacity":
        r, s = r.numpy().astype(np.int64), s.numpy().astype(np.int64)
        assert len(r) == cap and (r >= 0).all() and (s >= 0).all()
        assert (bk.numpy()[r] == pk.numpy()[s]).all()
        assert len(np.unique(r << 32 | s)) == cap


def test_the_record_deque_stays_bounded():
    trace.clear()
    extra = 10
    with torch.profiler.profile(activities=CPU):
        for i in range(trace.MAX_RECORDS + extra):
            with trace.span("s", join=i):
                pass
    recs = _spans()
    assert len(recs) == trace.MAX_RECORDS
    assert recs[0]["join"] == extra and recs[-1]["join"] == \
        trace.MAX_RECORDS + extra - 1
    trace.clear()
    assert _spans() == []


def test_setup_records_stay_through_clear():
    trace.clear()
    setup = {r["name"]: r for r in trace.records() if r["kind"] == "setup"}
    assert setup["setup.import"]["host_ms"] > 0
    # kept once the kernel library has loaded in this process (never on
    # the CPU path; on a card after any earlier kernel launch)
    assert ("setup.kernels" in setup) == (_build._lib is not None)
    if "setup.kernels" in setup:
        assert setup["setup.kernels"]["host_ms"] > 0
        assert setup["setup.kernels"]["device_ms"] is None


def test_the_table_sums_by_name_and_counts_syncs():
    trace.clear()
    with torch.profiler.profile(activities=CPU):
        _join(40)
        _join(40)
    rows = {r["name"]: r for r in trace.table(_spans())}
    assert rows["build"]["count"] == rows["sync.group_heads"]["count"] == 2
    assert "sync.fits" not in rows
    assert rows["materialize.fill"]["syncs"] == 4
    assert rows["group_heads"]["syncs"] == 2
    assert rows["build"]["syncs"] == rows["count"]["syncs"] == 0
    assert rows["count"]["device_ms"] is None
    assert rows["count"]["host_ms"] == pytest.approx(sum(
        r["host_ms"] for r in _spans() if r["name"] == "count"))


def test_the_cpu_path_launches_no_kernel():
    before = dict(trace.launches)
    with torch.profiler.profile(activities=CPU):
        _join(300)
    _join(10**6)
    assert dict(trace.launches) == before


def test_records_resolve_once_and_read_again():
    trace.clear()
    with torch.profiler.profile(activities=CPU):
        _join(40)
    assert trace.records() == trace.records()


def _given_a_tensor(monkeypatch) -> dict:
    """Span name -> whether ``ops/`` gave the span a tensor, for device
    time, the last time it opened one."""
    seen, real = {}, trace.span

    def span(name, on=None, join=-1):
        seen[name] = on is not None
        return real(name, on, join)
    monkeypatch.setattr(trace, "span", span)
    return seen


COUNT_TIMED = {"build", "build.sort", "count", "count.sort", "count.merge",
               "count.totals"}


@pytest.mark.parametrize("case", sorted(PATHS))
def test_the_expand_path_alone_gives_its_phases_device_time(monkeypatch,
                                                            case):
    """compact, offsets and pairs take a tensor for their event pair on
    the expand path, which runs over every matched row, and stay on the
    host clock on the host-paced paths; without a profiler nothing
    records."""
    dom, path, _ = PATHS[case]
    seen = _given_a_tensor(monkeypatch)
    trace.clear()
    assert _join(dom) == path
    assert _spans() == []
    with torch.profiler.profile(activities=CPU):
        assert _join(dom) == path
    timed = {name for name, on in seen.items() if on}
    assert timed == COUNT_TIMED | (
        {"compact", "offsets", "pairs"} if path == "expand" else set())
    assert {"compact", "offsets", "pairs"} <= {r["name"] for r in _spans()}


def test_the_v1_count_gives_its_search_device_time(monkeypatch):
    """v1's probe_count records count > count.search in the table's join,
    both given a tensor, only under a profiler."""
    seen = _given_a_tensor(monkeypatch)
    bk, pk = _keys(10**6)
    trace.clear()
    hash_join.probe_count(hash_join.build(bk), pk)
    assert _spans() == []
    with torch.profiler.profile(activities=CPU) as prof:
        ht = hash_join.build(bk)
        _, counts = hash_join.probe_count(ht, pk)
    recs = {r["name"]: r for r in _spans()}
    assert set(recs) == {"build", "build.sort", "count", "count.search"}
    assert recs["count.search"]["parent"] == "count"
    assert recs["count"]["parent"] is None
    assert recs["count"]["join"] == recs["count.search"]["join"] == \
        ht.trace_id >= 0
    assert seen["count"] and seen["count.search"]
    assert trace.PREFIX + "count.search" in {e.name for e in prof.events()}
    want = torch.searchsorted(ht.sorted_keys, pk, right=True) - \
        torch.searchsorted(ht.sorted_keys, pk)
    assert torch.equal(counts, want.int())
