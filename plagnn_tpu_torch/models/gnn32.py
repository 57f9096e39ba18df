"""The PLA-GNN flagship ``GNN32`` and the 2-layer ``GCN2``, for one fold.

Port of ``plagnn_tpu/models/gnn32.py``.  GNN32: three SAGEConv('pool')
layers (503 -> 400 -> 300 -> 200) with leaky_relu (slope 0.01) after each,
a 200 -> 100 Linear + leaky_relu, a 100 -> 12 Linear + sigmoid; the
reference's ``dropout`` argument is accepted and unused, as there.  GCN2
(BASELINE.json's "2-layer GCN"): GraphConv, relu, GraphConv, sigmoid.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_format import Graph
from .layers import GraphConv, Linear, SageConv

DEFAULT_DIMS = (400, 300, 200, 100)
NUM_CLASSES = 12


class GNN32(nn.Module):
    def __init__(self, in_feats: int, h1: int = 400, h2: int = 300,
                 h3: int = 200, h4: int = 100, num_classes: int = NUM_CLASSES,
                 dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del dropout  # accepted-but-unused, like the reference
        self.conv1 = SageConv(in_feats, h1, "pool", generator)
        self.conv2 = SageConv(h1, h2, "pool", generator)
        self.conv3 = SageConv(h2, h3, "pool", generator)
        self.liner1 = Linear(h3, h4, generator)
        self.liner2 = Linear(h4, num_classes, generator)

    def activations(self, graph: Graph, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-layer activations (the parity ladder of ``gnn32_activations``)."""
        acts = {}
        h = acts["conv1"] = self.conv1(graph, x)
        h = acts["conv2"] = self.conv2(graph, F.leaky_relu(h))
        h = acts["conv3"] = self.conv3(graph, F.leaky_relu(h))
        h = acts["liner1"] = self.liner1(F.leaky_relu(h))
        h = acts["liner2"] = self.liner2(F.leaky_relu(h))
        acts["out"] = torch.sigmoid(h)
        return acts

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        """Sigmoid probabilities (N_pad, num_classes)."""
        return self.activations(graph, x)["out"]


def init_gnn32(generator: Optional[torch.Generator], in_feats: int,
               h1: int = 400, h2: int = 300, h3: int = 200, h4: int = 100,
               num_classes: int = NUM_CLASSES) -> GNN32:
    return GNN32(in_feats, h1, h2, h3, h4, num_classes, generator=generator)


class GCN2(nn.Module):
    def __init__(self, in_feats: int, hidden: int, num_classes: int = NUM_CLASSES,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = GraphConv(in_feats, hidden, generator)
        self.conv2 = GraphConv(hidden, num_classes, generator)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        """Sigmoid probabilities (N_pad, num_classes)."""
        h = torch.relu(self.conv1(graph, x))
        return torch.sigmoid(self.conv2(graph, h))


def init_gcn2(generator: Optional[torch.Generator], in_feats: int, hidden: int,
              num_classes: int = NUM_CLASSES) -> GCN2:
    return GCN2(in_feats, hidden, num_classes, generator=generator)


# cfg.model -> one fold's init; GNN32 takes every width of cfg.hidden, GCN2
# its first.
MODEL_REGISTRY = {"gnn32": init_gnn32, "gcn2": init_gcn2}
