"""Aggregation: device ms per epoch of the port's aggregation kernels
(``csrc/spmm_max_fwd.cu``, ``spmm_max_bwd.cu``, ``spmm_sum.cu``: chunk,
grouped, hub and combine kernels) in the traced stretches."""

PATTERNS = ("spmm_",)


def read(ctx):
    ms = ctx.kernel_ms(PATTERNS)
    return ms if ms > 0 else None
