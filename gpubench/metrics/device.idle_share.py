"""Device: the share of the traced window in which no device operation ran,
100 x (1 - union of the operations' intervals / the window's wall time), in
%.  The profiler's host overhead lengthens the window where the host paces
the epoch, so there it reads above the untraced idle share."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
