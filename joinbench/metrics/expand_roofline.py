"""expand_roofline: the expand path's share of its HBM roofline, in %: the
bytes the pair columns need from a join's matched rows and pairs
(joinbench.roofline.materialize_bytes), mean over the window's joins, over
the card's peak, divided by the device ms a join of the program's spans
``compact``, ``offsets`` and ``pairs`` over the profiled slices' joins.
The bytes are the function's, not the kernels', so the yardstick stays
when K3 or K7b is fused or replaced."""
import statistics

from joinbench import roofline, spans

PHASES = ("compact", "offsets", "pairs")


def read(r):
    ms = spans.per_join(r, lambda s: s["name"] in PHASES, "device_ms")
    peak = roofline.hbm_peak(r.device_name)
    if not ms or peak is None or not r.counters.get("total"):
        return None
    need = statistics.fmean(
        roofline.materialize_bytes(rows, pairs) for rows, pairs in
        zip(r.counters["nonzero"], r.counters["total"]))
    return 100 * (need / peak) / (ms / 1e3)
