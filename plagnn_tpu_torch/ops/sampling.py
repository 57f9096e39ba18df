"""Neighbour sampling (the optional mini-batch path).

Port of ``plagnn_tpu/ops/sampling.py``.  The reference trains full-batch;
the sampler draws, per destination node, up to ``fanout`` uniform
in-neighbours without replacement (GraphSAGE-style fan-out) on the host
with numpy, the same edges as the JAX package from the same seed.
``sampled_graph`` builds the port's ``Graph`` of the sample, which the
aggregation kernels take like any other graph.  The JAX version pads the
edge list to ``n_nodes * (fanout + 1)`` (``edge_multiple``) so that every
epoch's sample has one compiled shape; PyTorch compiles nothing per shape,
so the port builds the sample's edges as they are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .graph_format import Graph, build_graph


def sample_neighbors(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    fanout: int,
    seed: int = 0,
    *,
    seeds: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform fan-out sampling of in-edges, fully vectorized.

    seeds: destination nodes to sample for (all nodes when None).
    Returns (src', dst') of the sampled edge set; nodes with <= fanout
    in-edges keep all of them.

    Without-replacement uniformity comes from one random key per edge: a
    (dst, key) lexsort permutes each destination row uniformly, and taking
    the first ``fanout`` positions of each row is then a uniform k-subset,
    O(E log E) in all.
    """
    rng = np.random.default_rng(seed)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if seeds is not None:
        sel_mask = np.zeros(n_nodes, bool)
        sel_mask[np.asarray(seeds, np.int64)] = True
        keep = sel_mask[dst]
        src, dst = src[keep], dst[keep]
    if not len(dst):
        return np.empty(0, np.int64), np.empty(0, np.int64)
    order = np.lexsort((rng.random(len(dst)), dst))
    src, dst = src[order], dst[order]
    counts = np.bincount(dst, minlength=n_nodes)
    row_start = np.zeros(n_nodes, np.int64)
    np.cumsum(counts[:-1], out=row_start[1:])
    pos_in_row = np.arange(len(dst)) - row_start[dst]
    keep = pos_in_row < fanout
    return src[keep], dst[keep]


def sampled_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    fanout: int,
    seed: int = 0,
    *,
    add_self_loops: bool = True,
    **graph_kwargs,
) -> Graph:
    """Sample, then build the port's Graph of the sampled edges
    (``graph_kwargs`` go to ``build_graph``: ``row_chunk``, ``device``)."""
    s, d = sample_neighbors(src, dst, n_nodes, fanout, seed)
    return build_graph(s, d, n_nodes, add_self_loops=add_self_loops, **graph_kwargs)
