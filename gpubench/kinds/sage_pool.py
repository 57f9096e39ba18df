"""SAGEConv, aggregator 'pool' (DGL 0.8):

    pooled = relu(h W_pool + b_pool)
    m_i    = max over in-edges j -> i of pooled_j    (0 for a row without in-edges)
    out    = h W_self + m W_neigh + bias

Init laws (weights stored (in, out)): Xavier-uniform with gain sqrt(2) for
W_self, W_neigh and W_pool, torch-Linear U(+-1/sqrt(in)) for b_pool, zero
bias.  The messages are in the configuration's ``agg_dtype``.
"""
import math

import torch

from gpubench.counts import max_bwd_bytes, max_fwd_bytes
from gpubench.reference.model import agg_dtype, first_max


def xavier(i: int, o: int, gain: float) -> float:
    return gain * math.sqrt(6.0 / (i + o))


def leaves(layer):
    """(leaf, shape of one fold's leaf, bound) in draw order."""
    i, o = layer["in"], layer["out"]
    gain = math.sqrt(2.0)
    return [("w_self", (i, o), xavier(i, o, gain)),
            ("w_neigh", (i, o), xavier(i, o, gain)),
            ("bias", (o,), 0.0),
            ("w_pool", (i, i), xavier(i, i, gain)),
            ("b_pool", (i,), 1.0 / math.sqrt(i))]


def forward(layer, config, graph, h, p):
    pooled = torch.relu(h @ p["w_pool"] + p["b_pool"])
    m = first_max(graph, pooled, agg_dtype(config))
    return h @ p["w_self"] + m @ p["w_neigh"] + p["bias"]


def matmuls(layer, first: bool):
    """(multiply-adds a node, whether the input takes a gradient): pool and
    self read the layer input; neigh reads the maxima of the pooled
    messages, which take a gradient through W_pool."""
    i, o = layer["in"], layer["out"]
    return [(i * i, not first), (i * o, not first), (i * o, True)]


def aggregation_bytes(layer, g, folds: int, esize: int) -> int:
    """A max forward and its backward at K = folds x in, ``esize``-byte
    messages."""
    k = folds * layer["in"]
    return max_fwd_bytes(g, k, esize) + max_bwd_bytes(g, k, esize)
