"""materialize_ms: the mean over the window's joins of the materialize
call's span (merge_join.plan_materialize: K3, the offsets' cumsum and
K7b; or the group heads and K5), from CUDA events recorded on the
stream before and after it."""
import statistics


def read(r):
    spans = r.spans_ms.get("materialize")
    return statistics.fmean(spans) if spans else None
