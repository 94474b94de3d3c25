"""The harness on the CPU at a tiny size: a run that is correct, the
control and each fault the cells can have coming out not correct, a
configuration, a mix and a metric added as new files only, and the
import check. The card tests run the cells themselves."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from joinbench import control, harness, run, trace
from one_table import CELL, add_one_table, run_copy
from tpujoin_torch.ops import merge_join

BENCH = harness.HERE
ROOT = BENCH.parent
TINY = {"name": "tiny", "build_rows": 3000, "probe_rows": 2500,
        "key_min": 1, "key_max": 300, "key_dtype": "int32",
        "distribution": "uniform", "engine": "v2",
        "pair_capacity_multiple": 1024, "row_capacity_multiple": 1024}
CPU = torch.device("cpu")
SEED = 2**31 + 11
ENV = {**os.environ, "PYTHONPATH": str(ROOT)}


def add_cell(root: Path, config: dict, traffic: str, cell: str) -> None:
    """Add ``config`` under root/joinbench/configs and a cell of it under
    ``traffic`` to root/BENCHMARK.json, listed by every per-layer
    metric."""
    path = f"joinbench/configs/{config['name']}.json"
    (root / path).parent.mkdir(parents=True, exist_ok=True)
    (root / path).write_text(json.dumps(config))
    bench = json.loads((root / harness.BENCH_FILE).read_text())
    bench["configs"].append({"name": config["name"], "source": "test",
                             "file": path, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": config["name"],
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(cell)
    (root / harness.BENCH_FILE).write_text(json.dumps(bench))


@pytest.fixture
def tiny_root(tmp_path):
    shutil.copy(ROOT / harness.BENCH_FILE, tmp_path)
    add_cell(tmp_path, TINY, "pairs", "tiny.pairs")
    return tmp_path


def run_tiny(root, trace_on=False, calls=None, seconds=0.3):
    return harness.run_cell(root, "tiny.pairs", SEED, seconds, trace_on,
                            CPU, time.perf_counter(), calls=calls)


@pytest.mark.parametrize("trace_on", [False, True])
def test_tiny_cell_is_correct(tiny_root, trace_on):
    out = run_tiny(tiny_root, trace_on)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 4
    assert list(out)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0} for c in out["checks"].values())
    assert set(out["checks"]) == {"count_total_gap", "count_nonzero_gap",
                                  "count_rows_off", "pairs_off",
                                  "pair_total_gap"}
    want = ({"build_ms", "count_ms", "materialize_ms"} if trace_on else
            {"join_rows_per_s", "join_p95_ms", "setup_s"})
    # the memory, the rooflines and the idle share read nothing on the CPU
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_control_is_not_correct(tiny_root):
    calls = control.control_calls(BENCH / "calls", harness.load_module)
    out = run_tiny(tiny_root, calls=calls)
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["pairs_off"]["value"] > 0
    assert out["checks"]["count_rows_off"]["value"] > 0


def stale_pairs(monkeypatch):
    """The materialize hands back the columns it held from the join
    before, unchanged."""
    real, held = merge_join.plan_materialize, []

    def fake(*args, **kwargs):
        out = real(*args, **kwargs)
        held.append(out)
        return held[-2] if len(held) > 1 else out
    monkeypatch.setattr(merge_join, "plan_materialize", fake)


def half_batch(monkeypatch):
    """The count leaves out the second half of the probe rows."""
    real = merge_join.probe_count
    monkeypatch.setattr(merge_join, "probe_count", lambda table, keys:
                        real(table, keys[:keys.numel() // 2]))


def altered_answer(monkeypatch):
    """One pair of each join names another build row."""
    real = merge_join.plan_materialize

    def fake(table, *args, **kwargs):
        name, (r_ids, s_ids, total), replay = real(table, *args, **kwargs)
        r_ids[0] = (r_ids[0] + 1) % table.num_rows
        return name, (r_ids, s_ids, total), replay
    monkeypatch.setattr(merge_join, "plan_materialize", fake)


@pytest.mark.parametrize("fault", [stale_pairs, half_batch, altered_answer])
def test_each_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_root)
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["pairs_off"]["value"] > 0


def digests(tree: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_new_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / harness.BENCH_FILE, tmp_path)
    before = digests(tmp_path / "joinbench")
    (tmp_path / "joinbench/traffic/pairs_pool2.json").write_text(json.dumps(
        {**json.loads((BENCH / "traffic/pairs.json").read_text()),
         "pool": 2, "profile_joins": 2, "breakdown_joins": 2}))
    (tmp_path / "joinbench/metrics/joins_done.py").write_text(
        "def read(r):\n    return len(r.latency_s)\n")
    add_cell(tmp_path, {**TINY, "name": "tiny2", "key_max": 50},
             "pairs_pool2", "tiny2.pool2")
    bench = json.loads((tmp_path / harness.BENCH_FILE).read_text())
    bench["per_layer"].append(
        {"name": "joins_done", "unit": "joins", "better": "higher",
         "source": "host_clock", "layer": "harness",
         "moves": "join_rows_per_s", "workloads": ["tiny2.pool2"]})
    (tmp_path / harness.BENCH_FILE).write_text(json.dumps(bench))
    # and a configuration whose op is not a join: one table's group-by
    add_one_table(tmp_path)
    out = run_copy(tmp_path, "tiny2.pool2", 5, True, ROOT, join_ref=True)[
        "out"]
    assert out["correct"] and out["metrics"]["joins_done"]["value"] > 0
    out = run_copy(tmp_path, CELL, 5, True, ROOT)["out"]
    assert out["correct"] and out["metrics"]["aggregate_ms"]["value"] > 0
    assert not any(p.name in ("joins_done.py", "agg_reference.py")
                   for p in before)
    assert digests(tmp_path / "joinbench").items() >= before.items()


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    script = ("import sys, time, torch; sys.path.insert(0, sys.argv[1]); "
              "from joinbench import harness, run; "
              "out = harness.run_cell(harness.Path(sys.argv[2]), "
              "'tiny.pairs', 3, 0.3, False, torch.device('cpu'), "
              "time.perf_counter()); "
              "assert out['correct']; print(run.forbidden_modules())")
    done = subprocess.run([sys.executable, "-c", script, str(ROOT),
                           str(tiny_root)], env=ENV, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.splitlines()[-1] == "[]"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert "tpujoin_torch" in sys.modules
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "tpujoin", raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpujoin.core",
                        types.ModuleType("tpujoin.core"))
    assert run.forbidden_modules() == ["tpujoin"]


def run_cli(cwd: Path, env=None):
    return subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload", "low.pairs",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    done = run_cli(ROOT)
    assert done.returncode != 0 and done.stdout == ""


def test_run_with_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / harness.BENCH_FILE, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = run_cli(tmp_path, env)
    assert done.returncode != 0 and done.stdout == ""


def test_trace_union_and_idle_gaps():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert list(trace._gaps([(5, 6), (0, 2), (1, 3)])) == [(3, 5)]
    host = [(0, 10, "joinbench.count"), (2, 4, "aten::item")]
    assert trace._host_doing(host, 3) == "joinbench.count/aten::item"
    assert trace._host_doing(host, 8) == "joinbench.count"
    assert trace._host_doing(host, 11) == "host"


@pytest.mark.card
@pytest.mark.parametrize("cell", ["low.pairs", "high.pairs"])
@pytest.mark.parametrize("trace_on", ["0", "1"])
def test_cell_on_the_card(cell, trace_on):
    done = subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "1", "--trace", trace_on], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    bench = json.loads((ROOT / harness.BENCH_FILE).read_text())
    kind = "per_layer" if trace_on == "1" else "end_to_end"
    assert set(out["metrics"]) == {m["name"] for m in bench[kind]}
