"""GraphConv, norm 'both' (DGL 0.8): ``out = D_in^-1/2 A D_out^-1/2 (h W)
+ b``, W first where it narrows the rows (DGL's order), degrees counted with
the self-loops and clamped at 1.

Init laws: Xavier-uniform gain 1 for W, zero bias.  The sum runs in float32
whatever the configuration's ``agg_dtype``, as the port's GraphConv does
(the aggregation dtype reaches SAGE-pool's max messages only).
"""
import math

from gpubench.counts import sum_bytes
from gpubench.reference.model import gcn_both

FLOAT32 = 4


def leaves(layer):
    """(leaf, shape of one fold's leaf, bound) in draw order."""
    i, o = layer["in"], layer["out"]
    return [("weight", (i, o), math.sqrt(6.0 / (i + o))),
            ("bias", (o,), 0.0)]


def forward(layer, config, graph, h, p):
    w = p["weight"]
    h = gcn_both(graph, h @ w) if w.shape[0] > w.shape[1] else gcn_both(graph, h) @ w
    return h + p["bias"]


def matmuls(layer, first: bool):
    """(multiply-adds a node, whether the input takes a gradient)."""
    return [(layer["in"] * layer["out"], not first)]


def aggregation_bytes(layer, g, folds: int, esize: int) -> int:
    """A sum and its VJP at K = folds x min(in, out), in float32."""
    return 2 * sum_bytes(g, folds * min(layer["in"], layer["out"]), FLOAT32)
