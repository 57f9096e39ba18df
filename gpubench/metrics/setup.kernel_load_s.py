"""Set-up: host seconds of the port's kernel library loads in the process (the
span ``setup.kernel_load`` of ``ops/_build.py: load``'s miss path: the nvcc
build where the library is missing, and the ctypes load)."""
from gpubench.spans import span_seconds


def read(ctx):
    return span_seconds("setup.kernel_load")
