"""A one-table op made of new files only, for the harness's tests: a
group-by of one table of (key, value) rows, each key's row count and sum
of values. Its files are written into a copy of the benchmark, which a
subprocess then runs through ``harness.run_cell`` with the join's
reference patched to raise."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROWS, GROUPS = 4000, 37
CELL = "tiny.agg"
CONFIG = {"name": "tiny_agg", "rows": ROWS, "groups": GROUPS,
          "distribution": "key_values",
          "reference": "joinbench/agg_reference.py"}

FILES = {
    "keys/key_values.py": '''
"""One table of ``rows`` rows: i32 group keys in [0, groups) and i64
values."""
import torch


def inputs(gen, cfg):
    n, dev = cfg["rows"], gen.device
    return {"keys": torch.randint(0, cfg["groups"], (n,), generator=gen,
                                  device=dev, dtype=torch.int32),
            "values": torch.randint(-1000, 1000, (n,), generator=gen,
                                    device=dev, dtype=torch.int64)}


def rows(cfg):
    return cfg["rows"]
''',
    "calls/group_sum.py": '''
"""Each key's row count and sum of values, dense over [0, groups)."""
import torch

LAYER = "aggregate"
KEEP = ("counts", "sums")
LIMITS = {"groups_off": 0}
OFF_BY = 0


def run(op, cfg):
    keys = op["keys"].long()
    counts = torch.bincount(keys, minlength=cfg["groups"])
    sums = torch.zeros(cfg["groups"], dtype=torch.int64,
                       device=keys.device).index_add_(0, keys, op["values"])
    sums[0] += OFF_BY
    op.update(counts=counts, sums=sums)


def check(kept, ref):
    counts = torch.zeros_like(kept["counts"])
    sums = torch.zeros_like(kept["sums"])
    counts[ref["keys"]], sums[ref["keys"]] = ref["counts"], ref["sums"]
    return {"groups_off": int(((kept["counts"] != counts)
                               | (kept["sums"] != sums)).sum())}
''',
    "agg_reference.py": '''
"""The group-by's reference: the rows sorted by key, each run's length
and the difference of the values' running sum across it."""
import torch


def judge_ref(inputs):
    keys, order = torch.sort(inputs["keys"].long(), stable=True)
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    ends = torch.cumsum(counts, 0) - 1
    run_sums = torch.cumsum(inputs["values"][order], 0)[ends]
    sums = run_sums - torch.cat([run_sums.new_zeros(1), run_sums[:-1]])
    return {"keys": uniq, "counts": counts, "sums": sums}
''',
    "traffic/aggregate.json": json.dumps(
        {"why": "one group-by of one table after another", "loop": "closed",
         "clients": 1, "pool": 2, "calls": ["group_sum"],
         "profile_joins": 2, "breakdown_joins": 1}),
    "metrics/aggregate_ms.py": '''
"""The mean of the group-by call's span."""
import statistics


def read(r):
    spans = r.spans_ms.get("aggregate")
    return statistics.fmean(spans) if spans else None
''',
}


def add_one_table(root: Path, off_by: int = 0) -> None:
    """Write the op's files under root/joinbench, with the call's sum of
    key 0 off by ``off_by``, and its cell, listed by a new per-layer
    metric, into root/BENCHMARK.json."""
    bench_dir = root / "joinbench"
    for rel, text in {**FILES, f"configs/{CONFIG['name']}.json":
                      json.dumps(CONFIG)}.items():
        (bench_dir / rel).parent.mkdir(parents=True, exist_ok=True)
        (bench_dir / rel).write_text(
            text.replace("OFF_BY = 0", f"OFF_BY = {off_by}"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": CONFIG["name"], "source": "test",
         "file": f"joinbench/configs/{CONFIG['name']}.json", "reduced": [],
         "why": "test"})
    bench["workloads"].append({"name": CELL, "config": CONFIG["name"],
                               "traffic": "aggregate", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append(
        {"name": "aggregate_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "aggregate",
         "moves": "join_rows_per_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


# Runs a cell of the copy in the current directory, with the join's
# reference raising where the fourth argument is 1, and prints the result
# line with the rows and window the metrics read.
SCRIPT = """
import json, sys, time, torch
sys.path.insert(0, '.')
from joinbench import harness, reference


def never(*args, **kwargs):
    raise AssertionError("the join's reference ran")


if sys.argv[4] == '1':
    reference.factorize = never
readings = []
real = harness.Readings
harness.Readings = lambda *a: readings.append(real(*a)) or readings[-1]
out = harness.run_cell(harness.Path('.'), sys.argv[1], int(sys.argv[2]),
                       0.3, sys.argv[3] == '1', torch.device('cpu'),
                       time.perf_counter())
print(json.dumps({"out": out, "rows": readings[0].rows,
                  "window_s": readings[0].window_s}))
"""


def run_copy(root: Path, cell: str, seed: int, trace_on: bool, repo: Path,
             join_ref: bool = False) -> dict:
    """``cell`` of the copy at ``root`` through ``run_cell`` in a
    subprocess, the program imported from ``repo``; unless ``join_ref``,
    the join's reference raises."""
    done = subprocess.run(
        [sys.executable, "-c", SCRIPT, cell, str(seed), str(int(trace_on)),
         str(int(not join_ref))],
        cwd=root, env={**os.environ, "PYTHONPATH": str(repo)},
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    return json.loads(done.stdout.splitlines()[-1])
