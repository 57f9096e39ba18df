"""The PLA-GNN flagship ``GNN32``, the 2-layer ``GCN2`` and ``GAT``, for one fold.

Port of ``plagnn_tpu/models/gnn32.py``.  GNN32: three SAGEConv('pool')
layers (503 -> 400 -> 300 -> 200) with leaky_relu (slope 0.01) after each,
a 200 -> 100 Linear + leaky_relu, a 100 -> 12 Linear + sigmoid; the
reference's ``dropout`` argument is accepted and unused, as there.  GCN2
(BASELINE.json's "2-layer GCN"): GraphConv, relu, GraphConv, sigmoid.
GAT (no counterpart in the JAX package): the inductive PPI model of
arXiv:1710.10903 sec. 3.3 as DGL's ``examples/pytorch/gat/train_ppi.py``
builds it -- GATConv layers of ``heads[l]`` heads x ``hidden[l]``,
concatenated, each followed by ELU, a residual on every layer past the
first; a last GATConv of ``heads[-1]`` heads x ``num_classes`` with a
residual, its heads averaged, then sigmoid.  No dropout (the paper's PPI
setting has none).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_format import Graph
from ..utils.precision import aggregation_dtype
from .layers import GATConv, GraphConv, Linear, SageConv

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


GAT_HEADS = (4, 4, 6)
GAT_HIDDEN = (256, 256)


def gat_layers(in_feats: int, hidden: Sequence[int], heads: Sequence[int],
               num_classes: int) -> List[dict]:
    """GAT's layers in order: in, out (per head), heads, residual, elu."""
    if len(heads) != len(hidden) + 1:
        raise ValueError(f"GAT takes one head count a layer: {len(hidden)} hidden widths "
                         f"and the output layer need {len(hidden) + 1}, got {tuple(heads)}")
    outs = [*hidden, num_classes]
    ins = [in_feats] + [f * h for f, h in zip(hidden, heads)]
    last = len(outs) - 1
    return [dict(in_feats=i, out_feats=o, num_heads=h, residual=l > 0, elu=l < last)
            for l, (i, o, h) in enumerate(zip(ins, outs, heads))]


class GAT(nn.Module):
    """Layers ``conv1`` .. ``conv{len(heads)}`` (``gat_layers``)."""

    def __init__(self, in_feats: int, hidden: Sequence[int] = GAT_HIDDEN,
                 heads: Sequence[int] = GAT_HEADS, num_classes: int = NUM_CLASSES,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for l, spec in enumerate(gat_layers(in_feats, hidden, heads, num_classes)):
            setattr(self, f"conv{l + 1}", GATConv(**spec, generator=generator))
        self.heads = tuple(heads)

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        """Sigmoid probabilities (N_pad, num_classes): the last layer's heads
        averaged."""
        convs = [getattr(self, f"conv{l + 1}") for l in range(len(self.heads))]
        h = x
        for conv in convs[:-1]:
            h = conv(graph, h)
        out = convs[-1](graph, h)
        return torch.sigmoid(out.view(out.shape[0], self.heads[-1], -1).mean(1))


def init_gat(generator: Optional[torch.Generator], in_feats: int, *hidden: int,
             heads: Sequence[int] = GAT_HEADS, num_classes: int = NUM_CLASSES) -> GAT:
    return GAT(in_feats, hidden or GAT_HIDDEN, heads, num_classes, generator=generator)


def refuse_gat(cfg: Any) -> None:
    """GAT's aggregation (``ops/spmm.py: spmm_gat``) has no hub form, no
    bfloat16 messages and no sharded form yet: a ``TrainConfig`` that asks
    for one is refused, so none is ignored unseen."""
    if cfg.hub_cache not in ("auto", "off"):
        raise ValueError(f"GAT takes no hub cache (hub_cache={cfg.hub_cache!r}): its kernels "
                         "have no hub form; use 'auto' or 'off'")
    if aggregation_dtype() is not None:
        raise ValueError("GAT aggregates in float32 only: set the aggregation dtype to "
                         "float32 (--agg-dtype float32)")
    if cfg.mesh_fold * cfg.mesh_graph > 1:
        raise ValueError(f"GAT runs on one device: mesh fold={cfg.mesh_fold},"
                         f"graph={cfg.mesh_graph} is not supported for it")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """How the engine builds one fold of a model from a ``TrainConfig``:
    ``init(generator, in_feats, *widths, num_classes=, **extra)``, with
    every width of ``cfg.hidden`` where ``all_widths``, else its first;
    ``extra`` are fixed arguments of the model, which the checkpoint
    fingerprint records; ``refuse`` raises ValueError for a configuration
    the model cannot run."""

    init: Callable[..., nn.Module]
    all_widths: bool = False
    extra: Dict[str, Tuple[int, ...]] = dataclasses.field(default_factory=dict)
    refuse: Optional[Callable[[Any], None]] = None


# cfg.model -> its spec (engine.model_spec, init_fold_model)
MODEL_REGISTRY = {
    "gnn32": ModelSpec(init_gnn32, all_widths=True),
    "gcn2": ModelSpec(init_gcn2),
    "gat": ModelSpec(init_gat, all_widths=True, extra={"heads": GAT_HEADS}, refuse=refuse_gat),
}
