"""Graph-convolution layers as ``nn.Module``s.

Port of ``plagnn_tpu/models/layers.py``: SAGEConv, GraphConv and linear.
DGL 0.8.x ``SAGEConv`` semantics, aggregator 'pool':
    h_pool_j = relu(W_pool . h_j + b_pool)
    m_i      = max over in-neighbours j of h_pool_j      (0 if none)
    out_i    = W_self . h_i + W_neigh . m_i + bias
and 'mean' / 'sum' (m_i the mean / sum of the neighbours' h_j, no pool).
DGL ``GraphConv`` (norm 'both'): ``out = D_in^{-1/2} A D_out^{-1/2} X W + b``.
Weights are stored (in, out) as in the JAX package, so parameters carry
across unchanged (``models/convert.py``).  Init follows the torch
distributions: Xavier-uniform with gain sqrt(2) for the SAGE weights and
gain 1 for GraphConv's, torch-Linear default for ``b_pool`` and the dense
layers, zero output bias.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.graph_format import Graph
from ..ops.spmm import gcn_propagate, spmm_max, spmm_mean, spmm_sum
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


def aggregate_max(graph, pooled: torch.Tensor) -> torch.Tensor:
    """Segment max of pooled messages, in the aggregation dtype when one is
    set (bf16 messages; the result comes back in pooled's dtype).

    ``graph`` is a ``Graph`` (the single-device ``spmm_max``) or an
    aggregation hook: a callable from the messages (rows, ...) to their
    maxima, such as ``parallel.sharded.ShardedMaxAgg`` on one rank's graph
    shard, so the models run unchanged on a shard."""
    agg = graph if callable(graph) else (lambda msgs: spmm_max(graph, msgs))
    agg_dt = aggregation_dtype()
    if agg_dt is None:
        return agg(pooled)
    return agg(pooled.to(agg_dt)).to(pooled.dtype)


class SageConv(nn.Module):
    """One fold's SAGEConv over x (N_pad, F_in), aggregator 'pool', 'mean'
    or 'sum' (only 'pool' has ``w_pool``/``b_pool``)."""

    def __init__(self, in_feats: int, out_feats: int, aggregator: str = "pool",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregator not in ("pool", "mean", "sum"):
            raise ValueError(f"unknown aggregator {aggregator!r}")
        self.aggregator = aggregator
        self.w_self = nn.Parameter(xavier_uniform(in_feats, out_feats, _RELU_GAIN, generator))
        self.w_neigh = nn.Parameter(xavier_uniform(in_feats, out_feats, _RELU_GAIN, generator))
        self.bias = nn.Parameter(torch.zeros(out_feats))
        if aggregator == "pool":
            # fc_pool is a full torch Linear (in -> in)
            self.w_pool = nn.Parameter(
                xavier_uniform(in_feats, in_feats, _RELU_GAIN, generator))
            bound = 1.0 / math.sqrt(in_feats)
            self.b_pool = nn.Parameter(
                torch.empty(in_feats).uniform_(-bound, bound, generator=generator))

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        if self.aggregator == "pool":
            m = aggregate_max(graph, torch.relu(x @ self.w_pool + self.b_pool))
        elif self.aggregator == "mean":
            m = spmm_mean(graph, x)
        else:
            m = spmm_sum(graph, x)
        return x @ self.w_self + m @ self.w_neigh + self.bias


class GraphConv(nn.Module):
    """One fold's DGL GraphConv (norm 'both') over x (N_pad, F_in).

    Multiplies by W first when that narrows the rows to aggregate (DGL's
    matmul order), so the sum runs at min(F_in, F_out) per fold."""

    def __init__(self, in_feats: int, out_feats: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(xavier_uniform(in_feats, out_feats, 1.0, generator))
        self.bias = nn.Parameter(torch.zeros(out_feats))

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[0] > self.weight.shape[1]:
            return gcn_propagate(graph, x @ self.weight, bias=self.bias)
        return gcn_propagate(graph, x) @ self.weight + self.bias


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
