"""The program's own spans and set-up records (``tpujoin_torch.trace``),
which the span metrics read after the profiled slices: the spans record
while a profiler session records, so they cover those slices' joins.

A run off the card (``device_name`` "cpu") gives None, as does a program
that keeps no such records (no ``tpujoin_torch.trace``, or no record of a
metric's spans): the metric is then left out of the result line.
"""
from __future__ import annotations

import importlib


def records(r) -> list | None:
    """The program's records (dicts: name, parent, join, kind, host_ms,
    device_ms) in the run whose readings are ``r``, or None."""
    if r.device_name == "cpu":
        return None
    try:
        trace = importlib.import_module("tpujoin_torch.trace")
    except ImportError:
        return None
    return trace.records()


def per_join(r, select, field: str | None = None):
    """Over the joins, the sum of ``field`` over the records ``select``
    keeps, or with no ``field`` their number. A join is one distinct
    ``join`` id among the ``build`` records, and only records of those
    joins count. None without a join, and for a sum where a kept record
    lacks the field or none is kept; a number of 0 is a reading."""
    recs = records(r)
    if recs is None:
        return None
    joins = {rec["join"] for rec in recs if rec["name"] == "build"
             and rec["join"] >= 0}
    kept = [1 if field is None else rec[field] for rec in recs
            if rec["join"] in joins and select(rec)]
    if not joins or field is not None and (not kept or None in kept):
        return None
    return sum(kept) / len(joins)


def setup_s(r, name: str) -> float | None:
    """The host seconds of the set-up record ``name``, or None."""
    for rec in records(r) or ():
        if rec["name"] == name:
            return rec["host_ms"] / 1e3
    return None
