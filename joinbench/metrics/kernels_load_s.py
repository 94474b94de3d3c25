"""kernels_load_s: the seconds the program takes to build (nvcc, on a
checkout's first run) and load its kernel library, its set-up record
``setup.kernels``."""
from joinbench import spans


def read(r):
    return spans.setup_s(r, "setup.kernels")
