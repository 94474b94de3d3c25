"""sync_wait_ms: the host ms a join spends inside the program's ``sync.*``
records (the host's wait at each host sync of the program's calls, and
the copy), over the profiled slices' joins."""
from joinbench import spans


def read(r):
    return spans.per_join(r, lambda s: s["kind"] == "sync", "host_ms")
