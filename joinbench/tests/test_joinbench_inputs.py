"""An op's inputs as the configuration's generator names them: a one-table
op added as new files only runs correct, counts its table's rows once and
never runs the join's reference, and its faulted twin is not correct; the
joins' pools and rows are what they were; each configuration's reference
is the module it names."""
import json
import shutil
import time

import pytest
import torch

from joinbench import harness, reference
from one_table import CELL, ROWS, add_one_table, run_copy

ROOT = harness.HERE.parent
CPU = torch.device("cpu")
SEED = 2**31 + 29
JOINS = {"uniform": {"build_rows": 700, "probe_rows": 500, "key_min": 1,
                     "key_max": 90, "distribution": "uniform"},
         "tpch_orderkey": {"build_rows": 400, "probe_rows": 1611,
                           "distribution": "tpch_orderkey"}}


@pytest.fixture
def one_table_copy(tmp_path):
    """A copy of the benchmark at tmp_path; the op's files are added by
    each test."""
    shutil.copytree(harness.HERE, tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / harness.BENCH_FILE, tmp_path)
    return tmp_path


@pytest.mark.parametrize("trace_on", [False, True])
def test_one_table_op_is_correct_and_counts_its_rows_once(one_table_copy,
                                                          trace_on):
    add_one_table(one_table_copy)
    got = run_copy(one_table_copy, CELL, SEED, trace_on, ROOT)
    out = got["out"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert out["checks"] == {"groups_off": {"value": 0, "limit": 0}}
    assert got["rows"] == [ROWS] * out["attempted"]
    if trace_on:
        assert out["metrics"]["aggregate_ms"]["value"] > 0
    else:
        assert out["metrics"]["join_rows_per_s"]["value"] == pytest.approx(
            ROWS * out["attempted"] / got["window_s"])


def test_one_table_op_with_a_sum_off_by_one_is_not_correct(one_table_copy):
    add_one_table(one_table_copy, off_by=1)
    out = run_copy(one_table_copy, CELL, SEED, False, ROOT)["out"]
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["groups_off"]["value"] >= 1


@pytest.mark.parametrize("name", sorted(JOINS))
def test_join_pool_is_make_in_the_order_it_was_drawn(name):
    cfg = JOINS[name]
    keys = harness.generator(cfg)
    pool = harness.make_pool(keys, cfg, 3, SEED, harness.Device(CPU))
    gen = torch.Generator().manual_seed(SEED)
    for entry in pool:
        assert list(entry) == ["build_keys", "probe_keys"]
        for side, rows in (("build_keys", "build_rows"),
                           ("probe_keys", "probe_rows")):
            want = keys.make(gen, cfg[rows], cfg)
            assert entry[side].dtype == want.dtype
            assert torch.equal(entry[side], want)


@pytest.mark.parametrize("name", sorted(JOINS) + [
    "ref_low_selectivity", "ref_high_selectivity", "tpch_lineitem_orders"])
def test_join_rows_are_build_plus_probe(name):
    cfg = JOINS.get(name) or json.loads(
        (harness.HERE / "configs" / f"{name}.json").read_text())
    assert harness.generator(cfg).rows(cfg) == \
        cfg["build_rows"] + cfg["probe_rows"]


@pytest.mark.parametrize("name", ["ref_low_selectivity",
                                  "ref_high_selectivity",
                                  "tpch_lineitem_orders", None])
def test_each_configuration_is_judged_by_the_reference_it_names(name):
    cfg = {} if name is None else json.loads(
        (harness.HERE / "configs" / f"{name}.json").read_text())
    assert harness.load_reference(cfg) is reference


def test_tiny_join_cell_counts_build_plus_probe_rows(tmp_path, monkeypatch):
    """The tiny join cell of the harness's tests, its rows per op read
    where the metrics read them."""
    from test_joinbench_harness import TINY, add_cell
    shutil.copy(ROOT / harness.BENCH_FILE, tmp_path)
    add_cell(tmp_path, TINY, "pairs", "tiny.pairs")
    readings, real = [], harness.Readings
    monkeypatch.setattr(harness, "Readings",
                        lambda *a: readings.append(real(*a)) or readings[-1])
    out = harness.run_cell(tmp_path, "tiny.pairs", SEED, 0.3, False, CPU,
                           time.perf_counter())
    assert out["correct"]
    assert readings[0].rows == [TINY["build_rows"] + TINY["probe_rows"]] \
        * out["attempted"]
