"""Aggregation: device ms per epoch of GAT's edge-softmax backward
(``csrc/spmm_gat.cu``: ``spmm_gat_bwd_kernel`` over the transpose, its
combine, the der pass and the del pass) in the traced stretches."""

PATTERNS = ("spmm_gat_bwd",)


def read(ctx):
    ms = ctx.kernel_ms(PATTERNS)
    return ms if ms > 0 else None
