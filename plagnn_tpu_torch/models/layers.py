"""Graph-convolution layers as ``nn.Module``s.

Port of ``plagnn_tpu/models/layers.py``: SAGEConv, GraphConv and linear;
and GATConv, which the JAX package does not have.
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

DGL 0.8 ``GATConv`` (Velickovic et al., arXiv:1710.10903), H heads of
width F, ``fc`` with no bias:
    Wh = h . fc;  el_j = <Wh_j, attn_l>, er_i = <Wh_i, attn_r>   (per head)
    a_ij = softmax over i's in-edges j of leaky_relu(el_j + er_i, 0.2)
    out_i = sum_j a_ij Wh_j + residual_i + bias                  (per head)
then ELU where the layer has it; the residual is none, the input itself
(in = H*F) or ``h . res_fc`` (no bias).  Init: DGL's Xavier-normal at gain
sqrt(2) for ``fc``, ``attn_l``, ``attn_r`` and ``res_fc`` as Xavier-uniform
bounds of the same variance (``attn``'s fans those torch takes of DGL's
(1, H, F) tensor: H*F in, F out), zero bias.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_format import Graph
from ..ops.spmm import gcn_propagate, spmm_gat, spmm_max, spmm_mean, spmm_sum
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


def gat_residual(residual: bool, in_feats: int, out_feats: int, num_heads: int) -> str:
    """DGL GATConv's residual: the input itself where it is as wide as the
    heads' output, else ``res_fc``; "none" without one."""
    if not residual:
        return "none"
    return "identity" if in_feats == num_heads * out_feats else "linear"


def gat_attn_bound(out_feats: int, num_heads: int) -> float:
    """The Xavier bound at gain sqrt(2) of DGL's (1, H, F) ``attn_l`` /
    ``attn_r``: fan in H*F, fan out F."""
    return _RELU_GAIN * math.sqrt(6.0 / (num_heads * out_feats + out_feats))


def gat_logits(wh: torch.Tensor, attn_l: torch.Tensor, attn_r: torch.Tensor):
    """(el, er) of wh (N, ..., H, F) and attn (..., H, F): the per-head dot
    products, both from one batched product over the heads."""
    lr = torch.einsum("n...f,...fc->n...c", wh, torch.stack((attn_l, attn_r), -1))
    return lr[..., 0], lr[..., 1]


def gat_finish(out: torch.Tensor, res: Optional[torch.Tensor], bias: torch.Tensor,
               elu: bool) -> torch.Tensor:
    """out + residual + bias, then ELU where the layer has it (in place: the
    sum is a fresh tensor)."""
    out = out + bias if res is None else torch.add(out, res).add_(bias)
    return F.elu(out, inplace=True) if elu else out


class GATConv(nn.Module):
    """One fold's DGL 0.8 GATConv over x (N_pad, F_in) with ``num_heads``
    heads of ``out_feats``; returns the heads concatenated, (N_pad, H*F)."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int, residual: bool = False,
                 elu: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        hf = num_heads * out_feats
        self.residual = gat_residual(residual, in_feats, out_feats, num_heads)
        self.elu = elu
        self.fc = nn.Parameter(xavier_uniform(in_feats, hf, _RELU_GAIN, generator))
        bound = gat_attn_bound(out_feats, num_heads)
        self.attn_l = nn.Parameter(
            torch.empty(num_heads, out_feats).uniform_(-bound, bound, generator=generator))
        self.attn_r = nn.Parameter(
            torch.empty(num_heads, out_feats).uniform_(-bound, bound, generator=generator))
        if self.residual == "linear":
            self.res_fc = nn.Parameter(xavier_uniform(in_feats, hf, _RELU_GAIN, generator))
        else:
            self.register_parameter("res_fc", None)
        self.bias = nn.Parameter(torch.zeros(hf))

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        h, f = self.attn_l.shape
        wh = x @ self.fc
        el, er = gat_logits(wh.view(-1, h, f), self.attn_l, self.attn_r)
        out = spmm_gat(graph, wh, el, er, f)
        res = None
        if self.residual == "identity":
            res = x
        elif self.residual == "linear":
            res = x @ self.res_fc
        return gat_finish(out, res, self.bias, self.elu)
