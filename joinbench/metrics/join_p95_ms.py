"""join_p95_ms: the 95th percentile of the latency of every join in the
window, each on the host clock from its first call to the end of its
synchronize (Python's exclusive quantile method)."""
import statistics


def read(r):
    if len(r.latency_s) < 2:
        return None
    return statistics.quantiles(r.latency_s, n=20)[18] * 1e3
