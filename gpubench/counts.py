"""The work of one epoch, counted from the configuration's shapes and the
cell's graph, whatever implements it: the dense layers' model FLOPs and the
aggregations' compulsory HBM bytes.  The table of the card's peaks is here
too.

FLOPs (``device.mfu``): the dense matmuls over the real nodes, forward and
backward, at 2 FLOPs a multiply-add.  Each matmul's backward takes its weight
gradient and, unless its input is the feature tensor (which takes no
gradient), its input gradient.  Activations, the loss, the metrics, Adam and
the aggregations are not counted.  Each layer's kind gives its matmuls
(``matmuls`` of ``kinds/<kind>.py``).

Bytes (``aggregation.spmm_roofline``): each input read once and each output
written once, as the kernel table of PERF.md counts them (chip_smoke.py,
phases 3 and 4g): a max forward reads x and the index and writes out and the
argmax, its backward reads g, the argmax and the index and writes dx; a sum
reads x and the index and writes out, and its VJP is the same over the
transpose.  Each layer's kind sums its aggregations' bytes
(``aggregation_bytes`` of ``kinds/<kind>.py``) from the helpers here.  On a
positional graph (past 2^15 padded nodes) the argmax is an int16 rank, the
forward also reads ``mega_of`` and the backward ``t_rank`` and ``mega_of``,
and each mega row adds a side-table row of the argmax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .inputs import padded_nodes
from .reference.model import load_kind

# Published peaks (NVIDIA data sheet, SXM part, dense rates), at a power
# limit of 700 W, by a substring of torch.cuda.get_device_name().
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}

# The port's argmax conventions: node ids fit int16 up to 2^15 padded rows;
# past that the argmax is positional, a rank in int16 whose row is cut into
# segments of RANK_CAP edges.
ID16_ROWS = 1 << 15
RANK_CAP = (1 << 15) - 1


def peaks(device_name: str) -> Optional[dict]:
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    return None


@dataclasses.dataclass(frozen=True)
class GraphShape:
    n: int          # real nodes
    n_pad: int      # padded rows
    edges: int      # with the self-loops
    positional: bool
    n_mega: int     # rows of more than RANK_CAP in-edges (positional only)

    @property
    def arg_bytes(self) -> int:
        return 2 if self.positional or self.n_pad <= ID16_ROWS else 4


def graph_shape(n: int, dst: torch.Tensor, self_loops: bool) -> GraphShape:
    """The shape of the cell's graph from its directed edge list."""
    n_pad = padded_nodes(n)
    in_deg = torch.bincount(dst, minlength=n) + int(self_loops)
    positional = n_pad > ID16_ROWS
    n_mega = int((in_deg > RANK_CAP).sum()) if positional else 0
    return GraphShape(n=n, n_pad=n_pad, edges=int(dst.numel()) + (n if self_loops else 0),
                      positional=positional, n_mega=n_mega)


def _matmuls(config: dict):
    """(multiply-adds a node, whether the input takes a gradient) of every
    dense matmul of one fold's forward."""
    return [mm for i, layer in enumerate(config["layers"])
            for mm in load_kind(layer["kind"]).matmuls(layer, first=i == 0)]


def dense_flops_per_epoch(config: dict, n_real: int, folds: int) -> float:
    macs = sum(m * (3 if grad_in else 2) for m, grad_in in _matmuls(config))
    return 2.0 * n_real * folds * macs


def max_fwd_bytes(g: GraphShape, k: int, esize: int) -> int:
    idx = 4 * (g.n_pad + 1 + g.edges)
    side = g.n_mega * k * 2
    extra = 4 * g.n_pad if g.positional else 0
    return g.n_pad * k * esize + idx + extra + g.n_pad * k * (esize + g.arg_bytes) + side


def max_bwd_bytes(g: GraphShape, k: int, esize: int) -> int:
    idx = 4 * (g.n_pad + 1 + g.edges)
    side = g.n_mega * k * 2
    extra = 4 * g.edges + 4 * g.n_pad if g.positional else 0
    return g.n_pad * k * (esize + g.arg_bytes) + side + idx + extra + g.n_pad * k * esize


def sum_bytes(g: GraphShape, k: int, esize: int) -> int:
    return 2 * g.n_pad * k * esize + 4 * (g.n_pad + 1 + g.edges)


def aggregation_bytes_per_epoch(config: dict, g: GraphShape, folds: int,
                                esize: int = 4) -> int:
    """Compulsory bytes of one epoch's aggregations, each layer's kind
    counting its own at ``esize``-byte messages (SAGE-pool: a max forward
    and backward at K = folds x in; GraphConv: a float32 sum and its VJP at
    K = folds x min(in, out), W first where it narrows)."""
    return sum(load_kind(layer["kind"]).aggregation_bytes(layer, g, folds, esize)
               for layer in config["layers"])
