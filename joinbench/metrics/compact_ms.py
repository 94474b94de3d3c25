"""compact_ms: the device ms a join spends in the expand path's
compaction, the program's span ``compact`` (K3: compact3's count pass,
the cumsum of its block counts and its scatter), over the profiled
slices' joins."""
from joinbench import spans


def read(r):
    return spans.per_join(r, lambda s: s["name"] == "compact", "device_ms")
