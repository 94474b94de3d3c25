"""setup_s: the host clock from the process's start to the window's:
importing, the device's context, building or loading the kernels, the
input pool and the warm-up joins."""


def read(r):
    return r.setup_s
