"""sort_ms: the device ms a join spends in K1's two sorts, the program's
spans ``build.sort`` and ``count.sort`` (a histogram and four digit
passes each), over the profiled slices' joins."""
from joinbench import spans


def read(r):
    return spans.per_join(r, lambda s: s["name"] in ("build.sort", "count.sort"),
                          "device_ms")
