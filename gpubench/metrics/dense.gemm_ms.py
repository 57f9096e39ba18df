"""Dense layers: device ms per epoch of the GEMM kernels (cuBLAS and CUTLASS
names) in the traced stretches."""

PATTERNS = ("gemm", "gemv", "xmma", "cutlass", "splitkreduce", "cublas")


def read(ctx):
    return ctx.kernel_ms(PATTERNS)
