"""Set-up: host seconds of the process's first epoch (the first call of the
span ``runner.epoch``), which carries every first-use cost: lazy module
loads, the cuBLAS set-up, the allocator's first growth."""
from gpubench.spans import span_seconds


def read(ctx):
    return span_seconds("runner.epoch", first=True)
