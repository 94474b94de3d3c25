"""materialize_roofline: the materialize layer's share of its HBM
roofline, in %: the bytes the pair columns need from each join's matched
rows and pairs (joinbench.roofline.materialize_bytes) over the card's
peak, summed over the window's joins, divided by the sum of their
materialize spans."""
from joinbench import roofline


def read(r):
    spans, peak = r.spans_ms.get("materialize"), roofline.hbm_peak(
        r.device_name)
    if not spans or peak is None:
        return None
    need = sum(roofline.materialize_bytes(rows, pairs) for rows, pairs in
               zip(r.counters["nonzero"], r.counters["total"]))
    return 100 * (need / peak) / (sum(spans) / 1e3)
