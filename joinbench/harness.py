"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything is found by name. The cell names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, ``traffic/<name>.json``. The
configuration names its input generator, ``keys/<distribution>.py``, and
its reference, a path from the checkout's root; the mix names the calls an
op makes, each ``calls/<name>.py``, the size of the input pool and the
loop; each metric is ``metrics/<name>.py``. A new configuration, mix, call
or metric is a new file and an entry in ``BENCHMARK.json``: no file here
changes.

An op is one join, or any other operation of the program. A configuration
for an op that is not a join brings, as new files:

- its generator, with ``inputs(gen, cfg)``, the op's input columns drawn
  on ``gen``'s device as a dict of named tensors, and ``rows(cfg)``, the
  table rows one op reads;
- its calls, each with ``LAYER``, ``KEEP``, ``run(op, cfg)`` (reading the
  named inputs from ``op`` and adding its outputs to it) and, where it
  is judged, ``LIMITS`` and ``check(kept, ref)``;
- its reference module, with ``judge_ref(inputs)``, whose result each
  call's ``check`` receives as ``ref``;
- its metrics.

A run (:func:`run_cell`):

1. set-up: a pool of distinct inputs made on the device from the seed,
   and one warm-up op on each, which builds and loads the program's
   kernels;
2. the window: a closed loop with one client, one op after another
   through the pool, each ending in a synchronize and its result dropped
   before the next starts, until ``seconds`` have passed. One op, drawn
   from the seed, and the last keep their outputs for the comparison;
3. with ``trace``, CUDA events around each call of every op in the
   window give the layers' spans; after it, two short slices of ops run
   under torch.profiler, one tracing the device for its busy time, one
   tracing the host too for the breakdown;
4. the program's state is freed and the configuration's reference judges
   the kept outputs (``correct``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

import torch

from joinbench import trace

BENCH_FILE = "BENCHMARK.json"
HERE = Path(__file__).resolve().parent
JOIN_REFERENCE = "joinbench/reference.py"


@dataclasses.dataclass
class Cell:
    """One cell of BENCHMARK.json with its configuration, mix and metrics."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Readings:
    """What a run measured, which the metric readers read."""

    config: dict
    device_name: str
    setup_s: float
    window_s: float
    latency_s: list          # each op of the window, host clock
    rows: list               # each op's input rows (the generator's rows)
    join_peak_bytes: int | None   # device memory one op needs
    spans_ms: dict           # layer -> each op's span (trace only)
    counters: dict           # name -> each op's count (trace only)
    busy_s: float | None     # device busy in the profiled slice
    slice_s: float | None    # the profiled slice's length


def load_module(path: Path):
    """The Python file at ``path`` as a module."""
    name = "joinbench_" + "_".join(path.relative_to(HERE).with_suffix("")
                                   .parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json."""
    bench = json.loads((root / BENCH_FILE).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {BENCH_FILE}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(workload, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


class Device:
    """Synchronize, memory and span marks on one device; on the CPU, which
    runs each operation as it is called, the marks are host clock
    readings and the memory readings 0."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.name = (torch.cuda.get_device_name(device) if self.cuda
                     else "cpu")

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def allocated(self) -> int:
        return torch.cuda.memory_allocated(self.device) if self.cuda else 0

    def peak(self) -> int:
        return (torch.cuda.max_memory_allocated(self.device) if self.cuda
                else 0)

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def span_ms(self, start, end) -> float:
        if self.cuda:
            return start.elapsed_time(end)
        return (end - start) * 1e3


def generator(cfg: dict):
    """The configuration's input generator, ``keys/<distribution>.py``."""
    return load_module(HERE / "keys" / f"{cfg['distribution']}.py")


def load_reference(cfg: dict):
    """The reference module the configuration names, a path from the
    checkout's root. A configuration that names none is a join's: the
    tiny join configurations of the program's own tests name none."""
    path = Path(cfg.get("reference", JOIN_REFERENCE)).with_suffix("")
    return importlib.import_module(".".join(path.parts))


def make_pool(keys, cfg: dict, size: int, seed: int, dev: Device) -> list:
    """A pool of ``size`` distinct inputs, each the generator's dict of
    named columns, drawn on the device from ``seed``."""
    gen = torch.Generator(device=dev.device)
    gen.manual_seed(seed)
    pool = [keys.inputs(gen, cfg) for _ in range(size)]
    dev.sync()
    return pool


def run_join(calls, cfg: dict, inputs: dict, dev: Device, marks=None,
             labels: bool = False) -> dict:
    """One op: each call in turn on a shallow copy of its inputs, then a
    synchronize. ``marks`` gets a span mark before each call and after
    the last; ``labels`` names each call's host work in a profiler
    trace."""
    join = dict(inputs)
    for call in calls:
        if marks is not None:
            marks.append(dev.mark())
        label = (torch.profiler.record_function(trace.LABEL + call.LAYER)
                 if labels else contextlib.nullcontext())
        with label:
            call.run(join, cfg)
    if marks is not None:
        marks.append(dev.mark())
    dev.sync()
    return join


def _keep(join: dict, calls) -> dict:
    return {k: join[k] for call in calls for k in call.KEEP}


@dataclasses.dataclass
class Window:
    """What the measured window produced."""

    seconds: float
    latency_s: list                # each join, host clock
    marks: list                    # each join's span marks (trace only)
    totals: list                   # each join's pairs (trace only)
    nonzeros: list                 # each join's matched rows (trace only)
    kept: dict                     # join index -> outputs kept to judge
    join_peak_bytes: int | None
    process_peak_bytes: int
    paths: list                    # the materialize paths taken


def warm_up(calls, cfg: dict, pool: list, dev: Device) -> float:
    """One join on each input, the first one's kept outputs held through
    the rest, as the window holds its sampled join's; returns the last
    join's seconds."""
    held = None
    for i, inputs in enumerate(pool):
        start = time.perf_counter()
        join = run_join(calls, cfg, inputs, dev)
        seconds = time.perf_counter() - start
        if i == 0:
            held = _keep(join, calls)
        del join
    del held
    return seconds


def run_window(calls, cfg: dict, pool: list, dev: Device, seconds: float,
               sampled: int, trace_on: bool) -> Window:
    """Joins one after another through the pool until ``seconds`` have
    passed, each result dropped before the next join starts; the join
    ``sampled`` and the last keep their outputs. The device memory one
    join needs is the allocator's peak less what was allocated before it:
    the peak is read and reset once after the sampled join, whose outputs
    stay."""
    w = Window(0.0, [], [], [], [], {}, None, dev.peak(), [])
    segment_peaks, paths, last, reset_due, i = [], set(), None, False, 0
    base = dev.allocated()
    dev.reset_peak()
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        last = None
        if reset_due:
            segment_peaks.append(dev.peak() - base)
            w.process_peak_bytes = max(w.process_peak_bytes, dev.peak())
            dev.reset_peak()
            base, reset_due = dev.allocated(), False
        marks = [] if trace_on else None
        start = time.perf_counter()
        last = run_join(calls, cfg, pool[i % len(pool)], dev, marks)
        w.latency_s.append(time.perf_counter() - start)
        paths.add(str(last.get("path")))
        if trace_on:
            w.marks.append(marks)
            w.totals.append(last.get("total"))
            w.nonzeros.append(last.get("nonzero"))
        if i == sampled:
            w.kept[i], reset_due = _keep(last, calls), True
        i += 1
    w.seconds = time.perf_counter() - t_start
    segment_peaks.append(dev.peak() - base)
    w.process_peak_bytes = max(w.process_peak_bytes, dev.peak())
    w.join_peak_bytes = max(segment_peaks) if dev.cuda else None
    w.kept.setdefault(i - 1, _keep(last, calls))
    w.paths = sorted(paths)
    return w


def profile_slices(calls, cfg: dict, pool: list, dev: Device,
                   traffic: dict) -> dict:
    """The traffic's two profiled slices of joins (:func:`trace.profile`)."""
    def joins(key):
        def run():
            for j in range(traffic[key]):
                run_join(calls, cfg, pool[j % len(pool)], dev, labels=True)
        return run
    return trace.profile(joins("profile_joins"), joins("breakdown_joins"),
                         dev.sync)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace_on: bool, device: torch.device, t0: float,
             calls=None) -> dict:
    """One run of ``workload``; returns its result line as a dict.
    ``t0`` is the host clock at the process's start, from which set-up
    counts; ``calls`` replace the traffic's calls (the control)."""
    cell = load_cell(root, workload)
    cfg, traffic = cell.config, cell.traffic
    keys = generator(cfg)
    if (traffic["loop"], traffic["clients"]) != ("closed", 1):
        raise ValueError("the harness drives a closed loop of one client")
    if calls is None:
        calls = [load_module(HERE / "calls" / f"{c}.py")
                 for c in traffic["calls"]]
    dev = Device(device)
    t_enter = time.perf_counter()
    pool = make_pool(keys, cfg, traffic["pool"], seed, dev)
    t_pool = time.perf_counter()
    last_warm_s = warm_up(calls, cfg, pool, dev)
    # the sampled join: drawn from the seed among the first half of the
    # joins the window is expected to complete
    sampled = int(random.Random(seed).random()
                  * max(seconds / max(last_warm_s, 1e-6) / 2, 1))
    t_start = time.perf_counter()
    print(f"joinbench: set-up {t_start - t0:.3f} s: {t_enter - t0:.3f} "
          f"imports and the card's check, {t_pool - t_enter:.3f} the pool "
          f"(with the CUDA context), {t_start - t_pool:.3f} the warm-up "
          f"joins (with the kernels' build or load)", file=sys.stderr)
    w = run_window(calls, cfg, pool, dev, seconds, sampled, trace_on)

    spans, prof = {}, {"busy_s": None, "window_s": None, "breakdown": None}
    if trace_on:
        for c, call in enumerate(calls):
            spans[call.LAYER] = [dev.span_ms(m[c], m[c + 1])
                                 for m in w.marks]
        w.marks = None
        prof = profile_slices(calls, cfg, pool, dev, traffic)
    readings = Readings(
        cfg, dev.name, t_start - t0, w.seconds, w.latency_s,
        [keys.rows(cfg)] * len(w.latency_s),
        w.join_peak_bytes, spans, {"total": w.totals, "nonzero": w.nonzeros},
        prof["busy_s"], prof["window_s"])

    if dev.cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks, failed = judge(calls, w.kept, pool, load_reference(cfg))
    _print_window(w, time.perf_counter() - t_judge)

    metrics = {}
    for m in cell.per_layer if trace_on else cell.end_to_end:
        value = load_module(HERE / "metrics" / f"{m['name']}.py") \
            .read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": failed == 0, "attempted": len(w.latency_s),
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.cuda else "cpu",
                      "kind": dev.name, "count": cell.chips,
                      "memory_peak_bytes": w.process_peak_bytes}}
    if trace_on:
        out["device"].update(busy_s=prof["busy_s"],
                             window_s=prof["window_s"])
        if prof["breakdown"] is not None:
            out["breakdown"] = prof["breakdown"]
    out["materialize_paths"] = w.paths
    out["checks"] = checks
    return out


def _print_window(w: Window, judge_s: float) -> None:
    """The window's joins on stderr: their latency and the comparison's
    time."""
    lat = w.latency_s
    ms = sorted(x * 1e3 for x in lat)
    half = len(lat) // 2
    halves = (sum(lat[:half]) / max(half, 1),
              sum(lat[half:]) / max(len(lat) - half, 1))
    print(f"joinbench: join ms min {ms[0]:.3f} median {ms[len(ms) // 2]:.3f}"
          f" max {ms[-1]:.3f}; the window's halves {halves[0] * 1e3:.4f} and"
          f" {halves[1] * 1e3:.4f} ms a join", file=sys.stderr)
    print(f"joinbench: {len(lat)} joins in {w.seconds:.3f} s; "
          f"{len(w.kept)} judged in {judge_s:.3f} s; materialize paths "
          f"{w.paths}", file=sys.stderr)


def judge(calls, kept: dict, pool: list, reference):
    """Each kept op's outputs against ``reference.judge_ref`` on its
    inputs. Returns each number compared, summed over the ops, beside its
    limit, and the number of ops with a number over its limit."""
    checks, failed = {}, 0
    for i, outputs in sorted(kept.items()):
        ref = reference.judge_ref(pool[i % len(pool)])
        over = False
        for call in calls:
            if not hasattr(call, "check"):
                continue
            for name, value in call.check(outputs, ref).items():
                entry = checks.setdefault(
                    name, {"value": 0, "limit": call.LIMITS[name]})
                entry["value"] += value
                over |= value > entry["limit"]
        failed += over
        del ref
    return checks, failed


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, one a line, on stderr."""
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
