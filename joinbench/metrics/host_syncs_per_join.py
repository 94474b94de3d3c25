"""host_syncs_per_join: the program's ``sync.*`` records a join, each one
host sync inside the program's calls (the group heads' nonzero, the
materialize's checked reads of the total and the matched rows), over the
profiled slices' joins. The benchmark's own read of the count's totals
is not one."""
from joinbench import spans


def read(r):
    return spans.per_join(r, lambda s: s["kind"] == "sync")
