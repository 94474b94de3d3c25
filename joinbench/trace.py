"""The device trace of a short slice of joins: the device's busy time, the
slice's length, and the breakdown (the device operations that took most
time, and the longest idle gaps of the device by what the host was doing).

The busy time is the union of the trace's device rows (kernels, copies,
fills), the method of the port's ``profile.py``; the harness's labels,
which the profiler also draws on the device's timeline, are no device
work and are left out. The events stay in memory.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

TOP = 10            # entries of each breakdown list
NAME_CHARS = 160    # of each entry's name
LABEL = "joinbench."   # prefix of the harness's own host labels


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def _gaps(intervals):
    """The gaps between the merged (start, end) intervals, in order."""
    reach = None
    for start, end in sorted(intervals):
        if reach is not None and start > reach:
            yield reach, start
        reach = end if reach is None else max(reach, end)


def _host_doing(host, at: float) -> str:
    """What the host was doing at ``at`` (us): the innermost host event
    that covers it, under the outermost one, as "outer/inner"."""
    covering = [e for e in host if e[0] <= at <= e[1]]
    if not covering:
        return "host"
    outer = max(covering, key=lambda e: e[1] - e[0])[2]
    inner = min(covering, key=lambda e: e[1] - e[0])[2]
    return outer if inner == outer else f"{outer}/{inner}"


def profile(run_busy, run_breakdown, sync) -> dict:
    """Run ``run_busy()`` and ``sync()`` under torch.profiler tracing the
    device alone, for ``busy_s`` and ``window_s`` (the host clock over the
    run and the sync), since recording every host operation slows the
    host and would widen the device's gaps; then ``run_breakdown()`` and
    ``sync()`` tracing the host too, for ``breakdown``. The device parts
    are None when a trace holds no device row, as on the CPU, where only
    ``run_busy`` runs."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        run_busy()
        sync()
        return {"busy_s": None, "window_s": time.perf_counter() - t0,
                "breakdown": None}
    device, _, window_s = _traced(run_busy, sync, host_too=False)
    device_all, host, _ = _traced(run_breakdown, sync, host_too=True)
    if not device or not device_all:
        return {"busy_s": None, "window_s": window_s, "breakdown": None}
    by_op = defaultdict(float)
    for start, end, name in device_all:
        by_op[name] += (end - start) / 1e6
    by_gap = defaultdict(float)
    for start, end in _gaps((s, e) for s, e, _ in device_all):
        by_gap[_host_doing(host, (start + end) / 2)] += (end - start) / 1e6
    return {"busy_s": union_length((s, e) for s, e, _ in device) / 1e6,
            "window_s": window_s,
            "breakdown": {"device_ops": _top(by_op),
                          "idle_gaps": _top(by_gap)}}


def _traced(run, sync, host_too: bool):
    """(device rows, host rows, seconds) of ``run()`` and ``sync()`` under
    torch.profiler, each row (start us, end us, name)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_too:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        seconds = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        row = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(row)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(LABEL)):
            device.append(row)
    return device, host, seconds


def _top(seconds: dict) -> list:
    """The TOP largest entries as [name, seconds], largest first."""
    return [[k[:NAME_CHARS], v] for k, v in
            sorted(seconds.items(), key=lambda kv: -kv[1])[:TOP]]
