"""The PLA-GNN flagship ``GNN32`` for one fold.

Port of ``plagnn_tpu/models/gnn32.py:24-78``: three SAGEConv('pool') layers
(503 -> 400 -> 300 -> 200) with leaky_relu (slope 0.01) after each, a
200 -> 100 Linear + leaky_relu, a 100 -> 12 Linear + sigmoid.  The
reference's ``dropout`` argument is accepted and unused, as there.  GCN2 is
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_format import Graph
from .layers import Linear, SageConvPool

DEFAULT_DIMS = (400, 300, 200, 100)
NUM_CLASSES = 12


class GNN32(nn.Module):
    def __init__(self, in_feats: int, h1: int = 400, h2: int = 300,
                 h3: int = 200, h4: int = 100, num_classes: int = NUM_CLASSES,
                 dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del dropout  # accepted-but-unused, like the reference
        self.conv1 = SageConvPool(in_feats, h1, generator)
        self.conv2 = SageConvPool(h1, h2, generator)
        self.conv3 = SageConvPool(h2, h3, generator)
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
