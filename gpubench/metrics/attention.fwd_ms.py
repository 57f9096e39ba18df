"""Aggregation: device ms per epoch of GAT's edge-softmax forward
(``csrc/spmm_gat.cu``: ``spmm_gat_fwd_kernel`` and its combine of split
rows) in the traced stretches."""

PATTERNS = ("spmm_gat_fwd",)


def read(ctx):
    ms = ctx.kernel_ms(PATTERNS)
    return ms if ms > 0 else None
