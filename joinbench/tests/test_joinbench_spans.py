"""The span metrics on a made-up record list: each reads its records a
join, counts only the joins of the build records, and reads nothing off
the card or from a program without spans."""
import sys
import types

import pytest

from joinbench import harness, spans

from tpujoin_torch import trace


def rec(name, join, kind="span", host_ms=0.0, device_ms=None, parent=None):
    return {"name": name, "parent": parent, "join": join, "kind": kind,
            "host_ms": host_ms, "device_ms": device_ms}


RECORDS = [
    rec("setup.import", -1, "setup", host_ms=1250.0),
    rec("setup.kernels", -1, "setup", host_ms=80.0),
    *(r for j in (0, 1) for r in (
        rec("build.ids", j, device_ms=0.5, parent="build"),
        rec("build.sort", j, device_ms=3.0, parent="build"),
        rec("build", j, device_ms=3.6),
        rec("count.ids", j, device_ms=0.4 + j, parent="count"),
        rec("count.sort", j, device_ms=3.5, parent="count"),
        rec("count", j, device_ms=5.0),
        rec("sync.neg", j, "sync", host_ms=0.25, parent="pairs"),
        rec("sync.fits", j, "sync", host_ms=1.5 + j, parent="materialize"),
    )),
    # not a join's: no build record, or no join id
    rec("count.ids", 7, device_ms=100.0),
    rec("sync.neg", 7, "sync", host_ms=100.0),
    rec("build.ids", -1, device_ms=100.0),
]

WANT = {"sort_ms": (3.0 + 3.5) * 2 / 2,
        "host_syncs_per_join": 2.0,
        "sync_wait_ms": (0.25 + 1.5 + 0.25 + 2.5) / 2,
        "import_s": 1.25,
        "kernels_load_s": 0.08}


CARD = types.SimpleNamespace(device_name="NVIDIA H100 80GB HBM3")


def read(name, readings=CARD):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py") \
        .read(readings)


@pytest.mark.parametrize("name", sorted(WANT))
def test_metric_reads_the_records(monkeypatch, name):
    monkeypatch.setattr(trace, "records", lambda: RECORDS)
    assert read(name) == pytest.approx(WANT[name])


PER_JOIN = ["sort_ms", "host_syncs_per_join", "sync_wait_ms"]


@pytest.mark.parametrize("name", PER_JOIN)
def test_per_join_metric_reads_nothing_without_a_join(monkeypatch, name):
    monkeypatch.setattr(trace, "records",
                        lambda: [r for r in RECORDS if r["name"] != "build"])
    assert read(name) is None


@pytest.mark.parametrize("records", ["all", "host_only", "no_sync"])
def test_ops_are_the_build_records(monkeypatch, records):
    """Every op counted has one build record, on each record set the
    metrics are read from, and a record of id 7, which has none, counts
    in no op."""
    recs = {"all": RECORDS,
            "host_only": [{**r, "device_ms": None} for r in RECORDS],
            "no_sync": [r for r in RECORDS if r["kind"] != "sync"]}[records]
    monkeypatch.setattr(trace, "records", lambda: recs)
    assert spans.per_join(CARD, lambda rec: rec["name"] == "build") == 1.0
    assert spans.per_join(CARD, lambda rec: rec["join"] == 7) == 0.0


@pytest.mark.parametrize("name", sorted(WANT))
def test_metric_reads_nothing_from_a_program_without_spans(monkeypatch,
                                                           name):
    monkeypatch.setitem(sys.modules, "tpujoin_torch.trace", None)
    assert read(name) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_metric_reads_nothing_off_the_card(monkeypatch, name):
    monkeypatch.setattr(trace, "records", lambda: RECORDS)
    assert read(name, types.SimpleNamespace(device_name="cpu")) is None


def test_device_metrics_read_nothing_without_device_time(monkeypatch):
    host_only = [{**r, "device_ms": None} for r in RECORDS]
    monkeypatch.setattr(trace, "records", lambda: host_only)
    assert read("sort_ms") is None
    assert read("host_syncs_per_join") == WANT["host_syncs_per_join"]


def test_no_sync_is_a_count_of_zero(monkeypatch):
    no_sync = [r for r in RECORDS if r["kind"] != "sync"]
    monkeypatch.setattr(trace, "records", lambda: no_sync)
    assert read("host_syncs_per_join") == 0
