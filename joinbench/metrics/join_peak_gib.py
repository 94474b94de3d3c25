"""join_peak_gib: the device memory one join needs, the allocator's peak
over the window less what was allocated before each join (the input pool,
and the sampled join's outputs kept for the comparison)."""


def read(r):
    if r.join_peak_bytes is None:
        return None
    return r.join_peak_bytes / 2**30
