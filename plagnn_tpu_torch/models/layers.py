"""Graph-convolution layers as ``nn.Module``s.

Port of ``plagnn_tpu/models/layers.py`` (SAGE-pool and linear; GraphConv is
not ported yet).  DGL 0.8.x ``SAGEConv(..., 'pool')`` semantics:
    h_pool_j = relu(W_pool . h_j + b_pool)
    m_i      = max over in-neighbours j of h_pool_j      (0 if none)
    out_i    = W_self . h_i + W_neigh . m_i + bias
Weights are stored (in, out) as in the JAX package, so parameters carry
across unchanged (``models/convert.py``).  Init follows the torch
distributions: Xavier-uniform with gain sqrt(2) for the weights,
torch-Linear default for ``b_pool`` and the dense layers, zero output bias.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.graph_format import Graph
from ..ops.spmm_kernels import spmm_max
from ..utils.precision import aggregation_dtype

_RELU_GAIN = math.sqrt(2.0)


def xavier_uniform(in_feats: int, out_feats: int, gain: float,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``torch.nn.init.xavier_uniform_`` of a torch (out, in) weight, stored
    transposed as (in, out)."""
    bound = gain * math.sqrt(6.0 / (in_feats + out_feats))
    return torch.empty(in_feats, out_feats).uniform_(-bound, bound, generator=generator)


def torch_linear_init(in_feats: int, out_feats: int,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.nn.Linear`` default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for both weight and bias."""
    bound = 1.0 / math.sqrt(in_feats)
    w = torch.empty(in_feats, out_feats).uniform_(-bound, bound, generator=generator)
    b = torch.empty(out_feats).uniform_(-bound, bound, generator=generator)
    return w, b


def aggregate_max(graph: Graph, pooled: torch.Tensor) -> torch.Tensor:
    """Segment max of pooled messages, in the aggregation dtype when one is
    set (bf16 messages; the result comes back in pooled's dtype)."""
    agg_dt = aggregation_dtype()
    if agg_dt is None:
        return spmm_max(graph, pooled)
    return spmm_max(graph, pooled.to(agg_dt)).to(pooled.dtype)


class SageConvPool(nn.Module):
    """One fold's SAGEConv('pool') over x (N_pad, F_in)."""

    def __init__(self, in_feats: int, out_feats: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_self = nn.Parameter(xavier_uniform(in_feats, out_feats, _RELU_GAIN, generator))
        self.w_neigh = nn.Parameter(xavier_uniform(in_feats, out_feats, _RELU_GAIN, generator))
        self.bias = nn.Parameter(torch.zeros(out_feats))
        # fc_pool is a full torch Linear (in -> in)
        self.w_pool = nn.Parameter(xavier_uniform(in_feats, in_feats, _RELU_GAIN, generator))
        bound = 1.0 / math.sqrt(in_feats)
        self.b_pool = nn.Parameter(
            torch.empty(in_feats).uniform_(-bound, bound, generator=generator))

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.relu(x @ self.w_pool + self.b_pool)
        m = aggregate_max(graph, pooled)
        return x @ self.w_self + m @ self.w_neigh + self.bias


class Linear(nn.Module):
    """``torch.nn.Linear`` with the weight stored (in, out)."""

    def __init__(self, in_feats: int, out_feats: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w, b = torch_linear_init(in_feats, out_feats, generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight + self.bias
