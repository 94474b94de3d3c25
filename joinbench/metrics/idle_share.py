"""idle_share: the share of the profiled slice's host-clock length, in %,
in which no operation ran on the device: 1 - (the union of the trace's
device rows) / (the slice's length)."""


def read(r):
    if not r.busy_s or not r.slice_s:
        return None
    return 100 * (1 - r.busy_s / r.slice_s)
