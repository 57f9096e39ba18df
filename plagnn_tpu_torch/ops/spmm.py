"""Neighbourhood-aggregation ops over the padded CSR graph.

Port of ``plagnn_tpu/ops/spmm.py``.  Reduction semantics are DGL 0.8.x's:

* ``spmm_max``:  ``out[i] = max_{j -> i} x[j]``, 0 for empty rows.
* ``spmm_sum``:  ``out[i] = sum_{j -> i} x[j]``.
* ``spmm_mean``: sum / in-degree (degree-0 rows stay 0).
* ``gcn_propagate``: degree-normalised propagation (DGL GraphConv norms).
* ``sddmm_dot``: per-edge ``<x[src], y[dst]>``.

``spmm_max`` and ``spmm_sum`` run the CUDA kernels of ``spmm_kernels`` on a
card (their plain versions on the CPU); the rest is plain PyTorch around
them.  The JAX package's ``segment_spmm_*`` oracles have their counterparts
in the kernels' plain versions.  The edge-value-weighted sum (``use_val``)
is not ported.
"""
from __future__ import annotations

import torch

from .graph_format import Graph
from .spmm_kernels import spmm_max, spmm_sum

__all__ = ["spmm_max", "spmm_sum", "spmm_mean", "gcn_propagate", "sddmm_dot"]

_NORMS = ("both", "left", "right", "none")


def _per_row(deg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Degrees clamped at 1 in x's dtype, shaped to scale x's rows."""
    d = deg.clamp(min=1).to(x.dtype)
    return d.reshape(-1, *([1] * (x.dim() - 1)))


def spmm_mean(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Mean aggregation: sum / in-degree (degree-0 rows stay 0)."""
    return spmm_sum(graph, x) / _per_row(graph.in_degree, x)


def gcn_propagate(graph: Graph, x: torch.Tensor, norm: str = "both") -> torch.Tensor:
    """Degree-normalised GCN propagation (DGL GraphConv semantics).

    norm='both':  D_out^{-1/2} applied to sources, D_in^{-1/2} to outputs.
    norm='right': divide by in-degree (mean).
    norm='left':  divide sources by out-degree.
    norm='none':  plain sum.
    """
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    if norm == "both":
        x = x * torch.rsqrt(_per_row(graph.out_degree, x))
    elif norm == "left":
        x = x / _per_row(graph.out_degree, x)
    s = spmm_sum(graph, x)
    if norm == "both":
        s = s * torch.rsqrt(_per_row(graph.in_degree, s))
    elif norm == "right":
        s = s / _per_row(graph.in_degree, s)
    return s


def sddmm_dot(graph: Graph, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products ``e = <x[src_e], y[dst_e]>`` over the edge list
    sorted by (dst, src); the JAX package's first E entries, which it pads
    with dummy-node products."""
    return (x[graph.src.long()] * y[graph.dst.long()]).sum(-1)
