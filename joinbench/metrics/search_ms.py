"""search_ms: the device ms a join spends in the v1 count's equal-range
search (its left and right bounds of each probe key in the sorted build
keys: on the card the key-range directory and the search kernel), the
program's span ``count.search``, over the profiled slices' joins."""
from joinbench import spans


def read(r):
    return spans.per_join(r, lambda s: s["name"] == "count.search",
                          "device_ms")
