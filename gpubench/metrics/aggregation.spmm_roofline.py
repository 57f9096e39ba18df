"""Aggregation: the epoch's compulsory aggregation bytes (``counts.py``,
from the graph and the widths) at the card's HBM rate, as a share of the
aggregation kernels' device time per epoch, in %."""


def read(ctx):
    ms = ctx.reader("aggregation.kernel_ms").read(ctx)
    if not ms or ctx.peaks is None:
        return None
    return 100.0 * ctx.agg_bytes_per_epoch / ctx.peaks["hbm_bytes_per_s"] / (ms / 1e3)
