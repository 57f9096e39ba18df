"""Fold-batched GNN32, GCN2 and GAT: the fold ensemble inside the feature layout.

Port of ``plagnn_tpu/models/batched.py`` (which batches GNN32; GCN2 and GAT
are batched the same way here).  Folds share the graph and the input features;
only the parameters differ.  Activations are (N, B, F), parameters carry a
leading fold axis (B, ...), the dense layers are ``einsum('nbf,bfg->nbg')``,
and one aggregation call serves every fold: the kernels take the (N, B*F)
rows as they are, so the JAX package's 1024/2048 stride padding (a TPU
tiling rule) is gone.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_format import Graph
from ..ops.spmm import gcn_propagate, spmm_gat
from .gnn32 import GAT, GCN2, GNN32, gat_layers
from .layers import aggregate_max, gat_finish, gat_logits, gat_residual


def _bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, B, F) or shared (N, F), w (B, F, G) -> (N, B, G)."""
    if x.dim() == 2:
        b, f, g = w.shape
        # shared input: one (N, F) x (F, B*G) product serves every fold
        return (x @ w.permute(1, 0, 2).reshape(f, b * g)).view(-1, b, g)
    return torch.einsum("nbf,bfg->nbg", x, w)


class BatchedSageConvPool(nn.Module):
    """SAGE-pool with fold-stacked parameters (leaves (B, ...))."""

    def __init__(self, folds: int, in_feats: int, out_feats: int):
        super().__init__()
        self.w_self = nn.Parameter(torch.empty(folds, in_feats, out_feats))
        self.w_neigh = nn.Parameter(torch.empty(folds, in_feats, out_feats))
        self.bias = nn.Parameter(torch.empty(folds, out_feats))
        self.w_pool = nn.Parameter(torch.empty(folds, in_feats, in_feats))
        self.b_pool = nn.Parameter(torch.empty(folds, in_feats))

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.relu(_bmm(x, self.w_pool) + self.b_pool)
        m = aggregate_max(graph, pooled)
        return _bmm(x, self.w_self) + _bmm(m, self.w_neigh) + self.bias


class BatchedLinear(nn.Module):
    def __init__(self, folds: int, in_feats: int, out_feats: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(folds, in_feats, out_feats))
        self.bias = nn.Parameter(torch.empty(folds, out_feats))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _bmm(x, self.weight) + self.bias


class BatchedGraphConv(nn.Module):
    """GraphConv with fold-stacked parameters; W first when in > out, as
    ``GraphConv`` does, so conv1 of GCN2 aggregates B*hidden per row, and
    the bias then rides in the propagation's store."""

    def __init__(self, folds: int, in_feats: int, out_feats: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(folds, in_feats, out_feats))
        self.bias = nn.Parameter(torch.empty(folds, out_feats))

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[1] > self.weight.shape[2]:
            return gcn_propagate(graph, _bmm(x, self.weight), bias=self.bias)
        return _bmm(gcn_propagate(graph, x), self.weight) + self.bias


class BatchedGATConv(nn.Module):
    """GATConv with fold-stacked parameters: one aggregation for every fold
    and head, K = B * H * F a row (``ops.spmm.spmm_gat``); returns the heads
    concatenated, (N, B, H*F)."""

    def __init__(self, folds: int, in_feats: int, out_feats: int, num_heads: int,
                 residual: bool = False, elu: bool = False):
        super().__init__()
        hf = num_heads * out_feats
        self.residual = gat_residual(residual, in_feats, out_feats, num_heads)
        self.elu = elu
        self.fc = nn.Parameter(torch.empty(folds, in_feats, hf))
        self.attn_l = nn.Parameter(torch.empty(folds, num_heads, out_feats))
        self.attn_r = nn.Parameter(torch.empty(folds, num_heads, out_feats))
        if self.residual == "linear":
            self.res_fc = nn.Parameter(torch.empty(folds, in_feats, hf))
        else:
            self.register_parameter("res_fc", None)
        self.bias = nn.Parameter(torch.empty(folds, hf))

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        b, h, f = self.attn_l.shape
        wh = _bmm(x, self.fc)
        el, er = gat_logits(wh.view(wh.shape[0], b, h, f), self.attn_l, self.attn_r)
        out = spmm_gat(graph, wh, el, er, f)
        res = None
        if self.residual == "identity":
            res = x if x.dim() == 3 else x[:, None]
        elif self.residual == "linear":
            res = _bmm(x, self.res_fc)
        return gat_finish(out, res, self.bias, self.elu)


def _stack_into(out: nn.Module, models: Sequence[nn.Module]) -> nn.Module:
    states = [m.state_dict() for m in models]
    out.load_state_dict({k: torch.stack([s[k] for s in states]) for k in states[0]})
    return out


class BatchedGNN32(nn.Module):
    """GNN32 over a fold batch; ``forward`` returns (N, B, num_classes)."""

    def __init__(self, folds: int, in_feats: int, h1: int = 400, h2: int = 300,
                 h3: int = 200, h4: int = 100, num_classes: int = 12):
        super().__init__()
        self.conv1 = BatchedSageConvPool(folds, in_feats, h1)
        self.conv2 = BatchedSageConvPool(folds, h1, h2)
        self.conv3 = BatchedSageConvPool(folds, h2, h3)
        self.liner1 = BatchedLinear(folds, h3, h4)
        self.liner2 = BatchedLinear(folds, h4, num_classes)

    @classmethod
    def stack(cls, models: Sequence[GNN32]) -> "BatchedGNN32":
        """Stack per-fold models (same widths) into one fold batch."""
        m0 = models[0]
        return _stack_into(
            cls(len(models), m0.conv1.w_self.shape[0], m0.conv1.w_self.shape[1],
                m0.conv2.w_self.shape[1], m0.conv3.w_self.shape[1],
                m0.liner1.weight.shape[1], m0.liner2.weight.shape[1]),
            models)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        """x: (N, F_in) shared by every fold, or (N, B, F_in)."""
        h = F.leaky_relu(self.conv1(graph, x))
        h = F.leaky_relu(self.conv2(graph, h))
        h = F.leaky_relu(self.conv3(graph, h))
        h = F.leaky_relu(self.liner1(h))
        return torch.sigmoid(self.liner2(h))


class BatchedGCN2(nn.Module):
    """GCN2 over a fold batch; ``forward`` returns (N, B, num_classes)."""

    def __init__(self, folds: int, in_feats: int, hidden: int, num_classes: int = 12):
        super().__init__()
        self.conv1 = BatchedGraphConv(folds, in_feats, hidden)
        self.conv2 = BatchedGraphConv(folds, hidden, num_classes)

    @classmethod
    def stack(cls, models: Sequence[GCN2]) -> "BatchedGCN2":
        """Stack per-fold models (same widths) into one fold batch."""
        w1, w2 = models[0].conv1.weight, models[0].conv2.weight
        return _stack_into(cls(len(models), w1.shape[0], w1.shape[1], w2.shape[1]),
                           models)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        """x: (N, F_in) shared by every fold, or (N, B, F_in)."""
        h = torch.relu(self.conv1(graph, x))
        return torch.sigmoid(self.conv2(graph, h))


class BatchedGAT(nn.Module):
    """GAT over a fold batch; ``forward`` returns (N, B, num_classes)."""

    def __init__(self, folds: int, in_feats: int, hidden: Sequence[int],
                 heads: Sequence[int], num_classes: int = 12):
        super().__init__()
        for l, spec in enumerate(gat_layers(in_feats, hidden, heads, num_classes)):
            setattr(self, f"conv{l + 1}", BatchedGATConv(folds, **spec))
        self.heads = tuple(heads)

    @classmethod
    def stack(cls, models: Sequence[GAT]) -> "BatchedGAT":
        """Stack per-fold models (same widths) into one fold batch."""
        m0 = models[0]
        convs = [getattr(m0, f"conv{l + 1}") for l in range(len(m0.heads))]
        return _stack_into(
            cls(len(models), convs[0].fc.shape[0], [c.attn_l.shape[1] for c in convs[:-1]],
                m0.heads, convs[-1].attn_l.shape[1]),
            models)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        """x: (N, F_in) shared by every fold, or (N, B, F_in)."""
        convs = [getattr(self, f"conv{l + 1}") for l in range(len(self.heads))]
        h = x
        for conv in convs[:-1]:
            h = conv(graph, h)
        out = convs[-1](graph, h)
        n, b = out.shape[:2]
        return torch.sigmoid(out.view(n, b, self.heads[-1], -1).mean(2))


def stack_folds(models: Sequence[nn.Module]) -> nn.Module:
    """The fold batch of per-fold GNN32, GCN2 or GAT models."""
    batched = {GNN32: BatchedGNN32, GCN2: BatchedGCN2, GAT: BatchedGAT}[type(models[0])]
    return batched.stack(models)
