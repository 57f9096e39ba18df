"""Set-up: host seconds of every ``train/runner.py: make_adam`` in the process
(the span ``setup.optimizer_init``); the first holds the import of
``torch._dynamo``."""
from gpubench.spans import span_seconds


def read(ctx):
    return span_seconds("setup.optimizer_init")
