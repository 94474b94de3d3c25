"""expand_pairs_ms: the device ms a join spends making the expand path's
pair columns, the program's span ``pairs`` (K7b, ``expand_runs``: one
fused expand-and-gather launch of the sorted build ids), over the
profiled slices' joins."""
from joinbench import spans


def read(r):
    return spans.per_join(r, lambda s: s["name"] == "pairs", "device_ms")
