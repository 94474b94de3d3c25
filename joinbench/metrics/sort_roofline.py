"""sort_roofline: the build's share of its HBM roofline, in %: the bytes
its sort needs (joinbench.roofline.sort_bytes) over the card's peak,
divided by the mean build span."""
import statistics

from joinbench import roofline


def read(r):
    spans, peak = r.spans_ms.get("build"), roofline.hbm_peak(r.device_name)
    if not spans or peak is None:
        return None
    bound_s = roofline.sort_bytes(r.config["build_rows"]) / peak
    return 100 * bound_s / (statistics.fmean(spans) / 1e3)
