"""build_ms: the mean over the window's joins of the build call's span
(hash_join.build: K1's sort, whose first pass makes the row ids), from
CUDA events recorded on the stream before and after it."""
import statistics


def read(r):
    spans = r.spans_ms.get("build")
    return statistics.fmean(spans) if spans else None
