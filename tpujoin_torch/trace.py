"""Spans and counters of tpujoin_torch: where a join's time goes.

A span (:func:`span`) marks one phase of the v2 join path (``build``,
``count``, ``materialize`` and their parts, named in ``ops/``). It records
only while a torch.profiler session records, which
``torch.autograd.profiler._is_profiler_enabled`` tells; otherwise
:func:`span` returns one shared no-op context, at the cost of that
attribute read. When on, a span

- enters a record function ``"tpujoin." + name`` (torch's
  ``_RecordFunctionFast``, ~1 us where ``torch.profiler.record_function``
  takes ~10 on an H100's host), so it lies in the profiler's timeline,
  among the host's events, on the same clock as the device's rows;
- reads the host clock at both ends;
- given a CUDA tensor, records a pair of timing events on its device's
  current stream (events are reused from a small pool). Each costs ~8 us
  of host time under the profiler, so ``ops/`` gives a tensor to the
  spans whose work the device paces (build, count, and the expand path's
  ``compact``, ``offsets`` and ``pairs``) and none to the host-paced
  spans of the other materialize paths, where the device waits on the
  host and the events would add to its idle time;
- keeps the name of its parent, the span around it, and its join's id:
  the one given, else its parent's. ``ops/hash_join.build`` draws a join's
  id (:func:`new_join`) and keeps it in its table.

:func:`sync` marks a host sync: a span of kind ``sync`` on the host clock
alone, since the host's wait is what it measures.

Records go to a deque of at most MAX_RECORDS. :func:`records` resolves
them, after the caller's synchronize, into dicts; :func:`clear` empties
it. Two set-up records are kept whether tracing is on or not, and
:func:`clear` leaves them: ``setup.import`` (the package's own imports,
from ``tpujoin_torch/__init__.py``) and ``setup.kernels`` (the kernel
library's build and load in ``kernels/_build.lib``).

``launches`` counts each kernel entry point's launches by its C name
(``tj_sort_pass``, ...): ``kernels/_build.call`` adds one a launch.

Readers: ``python -m tpujoin_torch.profile`` prints the span table
(:func:`table`), and the benchmark's per-layer metrics
(``joinbench/metrics``) read :func:`records`.
"""
from __future__ import annotations

import collections
import itertools
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 16
MAX_IDLE_EVENTS = 1024
PREFIX = "tpujoin."

launches: collections.Counter = collections.Counter()

_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_setup: dict = {}
_open: list = []          # the spans entered and not yet left, innermost last
_idle_events: list = []
_join_ids = itertools.count()


class _Off:
    """The context every span is while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _event() -> torch.cuda.Event:
    return (_idle_events.pop() if _idle_events
            else torch.cuda.Event(enable_timing=True))


class _Span:
    __slots__ = ("name", "kind", "join", "device", "stream", "parent",
                 "label", "t0", "start")

    def __init__(self, name: str, kind: str, join: int, device):
        self.name, self.kind, self.join, self.device = name, kind, join, device

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.parent = outer.name if outer else None
        if outer is not None and self.join < 0:
            self.join = outer.join
        self.label = _RecordFunctionFast(PREFIX + self.name)
        self.label.__enter__()
        _open.append(self)
        self.start = self.stream = None
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.start = _event()
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ms = (time.perf_counter_ns() - self.t0) / 1e6
        end = None
        if self.start is not None:
            end = _event()
            end.record(self.stream)
        _open.pop()
        self.label.__exit__(*exc)
        _records.append([self.name, self.parent, self.join, self.kind,
                         host_ms, self.start, end])
        return False


def span(name: str, on: torch.Tensor | None = None, join: int = -1):
    """A context that records span ``name`` while tracing is on, with
    device time on ``on``'s device when that is a CUDA tensor, in join
    ``join`` (else the parent's)."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, "span", join,
                 on.device if on is not None and on.is_cuda else None)


def sync(site: str):
    """A context around a host sync at ``site``: a record of kind
    ``sync`` named ``sync.<site>``, on the host clock alone."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span("sync." + site, "sync", -1, None)


def new_join() -> int:
    """A new join id while tracing is on, else -1."""
    return next(_join_ids) if _profiler._is_profiler_enabled else -1


def setup(name: str, seconds: float) -> None:
    """Keep the one-shot set-up record ``setup.<name>``."""
    _setup[name] = {"name": "setup." + name, "parent": None, "join": -1,
                    "kind": "setup", "host_ms": seconds * 1e3,
                    "device_ms": None}


def records() -> list[dict]:
    """The set-up records, then each span's in the order they ended, as
    dicts (name, parent, join, kind, host_ms, device_ms; device_ms None
    without a CUDA tensor). Call after synchronizing the devices the
    spans ran on: an event pair is resolved here, once."""
    out = list(_setup.values())
    for rec in _records:
        name, parent, join, kind, host_ms, start, end = rec
        if end is not None:       # an event pair not yet resolved
            rec[5], rec[6] = start.elapsed_time(end), None
            if len(_idle_events) < MAX_IDLE_EVENTS:
                _idle_events.extend((start, end))
        out.append({"name": name, "parent": parent, "join": join,
                    "kind": kind, "host_ms": host_ms, "device_ms": rec[5]})
    return out


def clear() -> None:
    """Drop every span's record (the set-up records stay)."""
    _records.clear()


def table(recs: list[dict]) -> list[dict]:
    """The records by name, in order of first appearance: count, device
    ms and host ms summed (device None where no record of it has device
    time), and the host syncs directly inside it (the ``sync`` records
    whose parent it is)."""
    syncs = collections.Counter(r["parent"] for r in recs
                                if r["kind"] == "sync")
    rows: dict = {}
    for r in recs:
        row = rows.setdefault(r["name"], {"name": r["name"], "count": 0,
                                          "device_ms": None, "host_ms": 0.0,
                                          "syncs": syncs[r["name"]]})
        row["count"] += 1
        row["host_ms"] += r["host_ms"]
        if r["device_ms"] is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + r["device_ms"]
    return list(rows.values())
