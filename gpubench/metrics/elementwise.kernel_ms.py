"""Loss, metrics, threshold, AUC, Adam and the model's activations: device ms
per epoch of every device operation of the traced stretches that is neither
a GEMM nor an aggregation kernel (copies and memsets included)."""


def read(ctx):
    named = ctx.reader("dense.gemm_ms").PATTERNS + ctx.reader("aggregation.kernel_ms").PATTERNS
    return ctx.kernel_ms(()) - ctx.kernel_ms(named)
