"""The TPC-H lineitem ⋈ orders deployment and the v1 cell on the CPU, at a
small scale: joinbench's order-key generator (TPC-H §4.2.3's sparse keys,
1 to 7 lineitems an order, the exact row count, seeded); the port's v2
join on those keys and its v1 count and materialize against joinbench's
reference; both cells through the harness at a tiny size; and the
metrics that read the expand path's and the v1 count's device spans."""
import json
import shutil
import sys
import time
import types

import pytest
import torch

from joinbench import compare, harness, reference
from tpujoin_torch import trace
from tpujoin_torch.ops import hash_join, merge_join
from tpujoin_torch.utils.shapes import round_up

KEYS = harness.load_module(harness.HERE / "keys" / "tpch_orderkey.py")
ORDERS = 1000
# lineitems: the 1-7 draws sum to ~4000 +- 63, so 3000 is always a cut
# and 4500 always an extension, by fewer rows than there are orders
LINEITEMS = (3000, 4000, 4500)
SEED = 2**31 + 77


def cfg(lineitems: int = 4000, orders: int = ORDERS) -> dict:
    return {"build_rows": orders, "probe_rows": lineitems}


def draw(n: int, config: dict, seed: int = SEED) -> torch.Tensor:
    return KEYS.make(torch.Generator().manual_seed(seed), n, config)


def order_index(keys: torch.Tensor) -> torch.Tensor:
    """The order number i whose key is ``keys`` (int64); a key off the
    8-of-32 rule maps to -1."""
    k = keys.long() - 1
    return torch.where(k % 32 < 8, k // 32 * 8 + k % 32, -1)


def lines_per_order(config: dict, seed: int = SEED) -> torch.Tensor:
    probe = draw(config["probe_rows"], config, seed)
    i = order_index(probe)
    assert bool((i >= 0).all()) and bool((i < config["build_rows"]).all())
    return torch.bincount(i, minlength=config["build_rows"])


def test_order_keys_are_unique_and_follow_the_8_of_32_rule():
    keys = draw(ORDERS, cfg())
    assert keys.dtype == torch.int32 and keys.numel() == ORDERS
    assert torch.equal(keys.sort().values,
                       KEYS.order_keys(torch.arange(ORDERS)))
    assert bool(((keys.long() - 1) % 32 < 8).all())
    assert int(keys.max()) == (ORDERS - 1) // 8 * 32 + (ORDERS - 1) % 8 + 1
    assert not torch.equal(keys, keys.sort().values)   # a random order


def test_the_spec_largest_key_fits_i32_at_sf100():
    last = KEYS.order_keys(torch.tensor([150_000_000 - 1]))
    assert int(last) == 599_999_976 < 2**31 - 1


@pytest.mark.parametrize("lineitems", LINEITEMS)
def test_every_lineitem_key_is_an_order_key_and_the_rows_are_exact(
        lineitems):
    config = cfg(lineitems)
    probe = draw(lineitems, config)
    assert probe.dtype == torch.int32 and probe.numel() == lineitems
    assert bool(torch.isin(probe, draw(ORDERS, config)).all())


def _adjusted_tail_holds(c: torch.Tensor) -> bool:
    """Whether the orders' lineitem counts ``c`` lie in 1..7 outside the
    adjusted tail: after a cut, every order before the first one cut short
    (which keeps 1 to 7 rows) and none after it; after an extension, every
    order once its share of the extension (one more row for the first
    orders) is taken off."""
    in_range = (c >= 1) & (c <= 7)
    if not bool(c.all()):                     # a cut
        cut = int((c > 0).sum()) - 1
        return (bool(in_range[:cut + 1].all())
                and not bool(c[cut + 1:].any()))
    ext = int(((c - 1 >= 1) & ~in_range).nonzero().max()) + 1 \
        if bool((c > 7).any()) else 0
    extended = (c[:ext] - 1 >= 1) & (c[:ext] - 1 <= 7)
    return bool(extended.all()) and bool(in_range[ext:].all())


@pytest.mark.parametrize("lineitems", LINEITEMS)
def test_each_order_has_1_to_7_lineitems_outside_the_adjusted_tail(
        lineitems):
    c = lines_per_order(cfg(lineitems))
    assert int(c.sum()) == lineitems
    assert _adjusted_tail_holds(c)
    if lineitems == 3000:
        assert not bool(c.all())                  # cut
    if lineitems == 4500:
        assert int((c == 8).sum()) > 0            # extended
    assert set(c[:ORDERS // 2].tolist()) <= set(range(1, 9))
    assert set(c[(c >= 1) & (c <= 7)].tolist()) == set(range(1, 8))


def test_the_tail_check_sees_a_count_out_of_range():
    c = torch.full((20,), 4)
    assert _adjusted_tail_holds(c)
    assert not _adjusted_tail_holds(torch.cat([c, torch.tensor([9, 4])]))
    assert not _adjusted_tail_holds(torch.cat([c, torch.tensor([0, 4])]))
    assert _adjusted_tail_holds(torch.cat([torch.tensor([8, 2]), c]))
    # an 8 past an order of 1 row: no prefix of orders took one more
    assert not _adjusted_tail_holds(torch.tensor([2, 1, 8, 4]))


def test_keys_are_seeded():
    config = cfg()
    for n in (ORDERS, 4000):
        assert torch.equal(draw(n, config), draw(n, config))
        assert not torch.equal(draw(n, config), draw(n, config, SEED + 1))


@pytest.mark.parametrize("n,config", [(1234, cfg()),
                                      (ORDERS, cfg(ORDERS))])
def test_make_refuses_a_side_it_cannot_tell(n, config):
    with pytest.raises(ValueError, match="neither"):
        draw(n, config)


def test_v2_join_on_order_keys_takes_expand_and_matches_the_reference():
    config = cfg(4000)
    bk, pk = draw(ORDERS, config), draw(4000, config)
    ht = hash_join.build(bk)
    state, total, nonzero = merge_join.probe_count(ht, pk)
    total, nonzero = int(total), int(nonzero)
    assert total == nonzero == 4000
    path, (r_ids, s_ids, pair_total), _ = merge_join.plan_materialize(
        ht, state, round_up(nonzero, 1024), round_up(total, 1024),
        total=total, nonzero=nonzero)
    assert path == "expand" and int(pair_total) == 4000
    ref = reference.factorize(bk, pk)
    assert ref.total == ref.nonzero == 4000
    assert compare.pair_checks(r_ids, s_ids, total, ref) == {"pairs_off": 0}
    assert set(compare.count_checks(state.probe_ids, state.counts, total,
                                    nonzero, ref).values()) == {0}
    assert torch.equal(bk[r_ids[:total].long()], pk[s_ids[:total].long()])


def _v1_join(key_max: int, seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    bk, pk = (torch.randint(1, key_max + 1, (n,), generator=gen,
                            dtype=torch.int32) for n in (3000, 2500))
    calls = [harness.load_module(harness.HERE / "calls" / f"{c}.py")
             for c in ("build", "v1_count", "v1_materialize")]
    join = {"build_keys": bk, "probe_keys": pk}
    for call in calls:
        call.run(join, {"pair_capacity_multiple": 1024})
    return calls, join, reference.factorize(bk, pk)


@pytest.mark.parametrize("key_max,path", [(10**6, "v1.search"),
                                          (300, "v1.fill")])
def test_v1_calls_match_the_reference(key_max, path):
    calls, join, ref = _v1_join(key_max)
    assert join["path"] == path and join["total"] == ref.total > 0
    checks = {}
    for call in calls[1:]:
        checks.update(call.check({k: join[k] for k in call.KEEP}, ref))
    assert set(checks) == {"count_total_gap", "count_nonzero_gap",
                           "count_rows_off", "pairs_off", "pair_total_gap"}
    assert set(checks.values()) == {0}


def test_v1_checks_see_a_wrong_count_and_a_wrong_pair():
    calls, join, ref = _v1_join(300)
    counts = join["counts"].clone()
    counts[0] += 1
    assert calls[1].check({**join, "counts": counts}, ref)[
        "count_rows_off"] == 1
    r_ids, s_ids = join["pairs"]
    r_ids = r_ids.clone()
    r_ids[0] = (r_ids[0] + 1) % 3000
    assert calls[2].check({**join, "pairs": (r_ids, s_ids)}, ref)[
        "pairs_off"] > 0


TINY = {"tiny_tpch": ({"name": "tiny_tpch", "build_rows": 2000,
                       "probe_rows": 8123, "distribution": "tpch_orderkey",
                       "engine": "v2", "pair_capacity_multiple": 1024,
                       "row_capacity_multiple": 1024}, "pkfk",
                      "tpch.pkfk", ["expand"]),
        "tiny_v1": ({"name": "tiny_v1", "build_rows": 3000,
                     "probe_rows": 2500, "key_min": 1, "key_max": 10**6,
                     "distribution": "uniform", "engine": "v1",
                     "pair_capacity_multiple": 1024,
                     "row_capacity_multiple": 1024}, "v1", "low.v1",
                    ["v1.search"])}


def tiny_root(tmp_path, name: str):
    """A copy of BENCHMARK.json with the tiny cell ``t.<traffic>`` of
    config ``name``, listed by the metrics that list its full-size cell."""
    config, traffic, cell, _ = TINY[name]
    shutil.copy(harness.HERE.parent / harness.BENCH_FILE, tmp_path)
    (tmp_path / f"{name}.json").write_text(json.dumps(config))
    bench = json.loads((tmp_path / harness.BENCH_FILE).read_text())
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"{name}.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": f"t.{traffic}", "config": name,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        if cell in m["workloads"]:
            m["workloads"].append(f"t.{traffic}")
    (tmp_path / harness.BENCH_FILE).write_text(json.dumps(bench))
    return tmp_path, f"t.{traffic}"


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_cell_runs_correct_through_the_harness(tmp_path, name,
                                                    trace_on):
    root, cell = tiny_root(tmp_path, name)
    out = harness.run_cell(root, cell, SEED, 0.3, trace_on,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1
    assert all(c == {"value": 0, "limit": 0} for c in out["checks"].values())
    assert out["materialize_paths"] == TINY[name][3]
    # the span metrics read nothing off the card, and do not raise
    want = set() if trace_on else {"join_rows_per_s", "join_p95_ms",
                                   "setup_s"}
    assert set(out["metrics"]) == want


def rec(name, join, device_ms=None, parent=None):
    return {"name": name, "parent": parent, "join": join, "kind": "span",
            "host_ms": 1.0, "device_ms": device_ms}


SPANS = [rec("build", j, 2.0) for j in (0, 1)] + [
    rec("compact", 0, 4.0, "materialize.expand"),
    rec("offsets", 0, 1.0, "materialize.expand"),
    rec("pairs", 0, 9.0, "materialize.expand"),
    rec("compact", 1, 6.0, "materialize.expand"),
    rec("offsets", 1, 1.0, "materialize.expand"),
    rec("pairs", 1, 11.0, "materialize.expand"),
    rec("count.search", 0, 30.0, "count"),
    rec("count.search", 1, 32.0, "count"),
    rec("pairs", 9, 500.0, "materialize.expand"),     # no build: no join
]
CARD = "NVIDIA H100 80GB HBM3"
PAIRS = 600_000_000


def readings(device=CARD, joins=3):
    return types.SimpleNamespace(
        device_name=device,
        counters={"total": [PAIRS] * joins, "nonzero": [PAIRS] * joins})


def read(name, r=None):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py") \
        .read(r or readings())


@pytest.mark.parametrize("name,want", [
    ("compact_ms", 5.0), ("expand_pairs_ms", 10.0), ("search_ms", 31.0),
    ("expand_roofline", 100 * 20 * PAIRS / 3.35e12 / 16e-3)])
def test_new_metrics_read_the_records(monkeypatch, name, want):
    monkeypatch.setattr(trace, "records", lambda: SPANS)
    assert read(name) == pytest.approx(want)


@pytest.mark.parametrize("name", ["compact_ms", "expand_pairs_ms",
                                  "expand_roofline", "search_ms"])
def test_new_metrics_read_nothing_from_the_parent_program(monkeypatch,
                                                          name):
    """The program before the spans had device time: the same records on
    the host clock alone, or none at all, or off the card."""
    host_only = [{**r, "device_ms": None} for r in SPANS]
    monkeypatch.setattr(trace, "records", lambda: host_only)
    assert read(name) is None
    monkeypatch.setattr(trace, "records",
                        lambda: [r for r in SPANS if r["name"] == "build"])
    assert read(name) is None
    monkeypatch.setattr(trace, "records", lambda: SPANS)
    assert read(name, readings("cpu")) is None
    monkeypatch.setitem(sys.modules, "tpujoin_torch.trace", None)
    assert read(name) is None


def test_expand_roofline_needs_the_window_counters(monkeypatch):
    monkeypatch.setattr(trace, "records", lambda: SPANS)
    assert read("expand_roofline", readings(joins=0)) is None
