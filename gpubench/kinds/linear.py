"""Linear (torch): ``h W + b``, both U(+-1/sqrt(in)); no aggregation."""
import math


def leaves(layer):
    """(leaf, shape of one fold's leaf, bound) in draw order."""
    i, o = layer["in"], layer["out"]
    return [("weight", (i, o), 1.0 / math.sqrt(i)),
            ("bias", (o,), 1.0 / math.sqrt(i))]


def forward(layer, config, graph, h, p):
    return h @ p["weight"] + p["bias"]


def matmuls(layer, first: bool):
    """(multiply-adds a node, whether the input takes a gradient)."""
    return [(layer["in"] * layer["out"], not first)]


def aggregation_bytes(layer, g, folds: int, esize: int) -> int:
    return 0
