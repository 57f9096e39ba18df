"""Matmul precision and aggregation dtype policy.

The reference trains in float32 end to end, and the JAX package pins
HIGHEST matmul precision.  On Hopper a float32 matmul may run through TF32
(about three decimal digits) when ``torch.backends.cuda.matmul.allow_tf32``
is set, and cuDNN convolutions do so by default.  This module turns TF32
off for both when it is imported ("highest"), and exposes the same switch
as the JAX package for throughput runs.
"""
from __future__ import annotations

import torch

# JAX precision name -> torch float32 matmul precision.  "default" maps to
# torch's "medium" (bf16 internally), as JAX's DEFAULT runs bf16 passes.
_TORCH_PRECISION = {"default": "medium", "high": "high", "highest": "highest"}

_MATMUL_PRECISION = "highest"


def set_matmul_precision(p: str) -> None:
    """p in {'default', 'high', 'highest'}; 'highest' turns TF32 off."""
    global _MATMUL_PRECISION
    p = p.lower()
    torch_p = _TORCH_PRECISION[p]
    tf32 = p != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision(torch_p)
    _MATMUL_PRECISION = p


def matmul_precision() -> str:
    return _MATMUL_PRECISION


_AGG_DTYPE = None  # None = keep float32 messages (parity); torch.bfloat16 = perf


def set_aggregation_dtype(dtype) -> None:
    """dtype of neighbourhood-aggregation messages: None keeps float32;
    'bfloat16' halves the gathered bytes (max is exact over the rounded
    values)."""
    global _AGG_DTYPE
    if isinstance(dtype, str):
        dtype = {"float32": None, "bfloat16": torch.bfloat16,
                 "none": None}[dtype.lower()]
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"unsupported aggregation dtype {dtype!r}")
    _AGG_DTYPE = dtype


def aggregation_dtype():
    return _AGG_DTYPE


set_matmul_precision(_MATMUL_PRECISION)
