"""count_ms: the mean over the window's joins of the count call's span
(merge_join.probe_count: K1, whose first pass makes the row ids, K2, the
int64 totals) with its read of the totals to the host, from CUDA events
recorded on the stream before and after it."""
import statistics


def read(r):
    spans = r.spans_ms.get("count")
    return statistics.fmean(spans) if spans else None
