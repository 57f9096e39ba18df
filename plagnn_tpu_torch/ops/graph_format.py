"""Padded CSR graph container for the aggregation kernels.

Port of ``plagnn_tpu/ops/graph_format.py:307-403`` (``build_graph``,
``from_scipy_coo``, ``pad_features``).  Node padding is the JAX package's:
``n_pad = round_up(n + 1, 128)``, so a dummy node at ``n_pad - 1`` always
exists, and explicit self-loops are appended when asked.  Edges are sorted
by destination, sources ascending inside each row: the order in which the
forward kernel's first-maximum tie rule is defined.

Differences from the JAX container:

* The edge list is not padded (the JAX package pads it to a multiple of
  1024 with dummy -> dummy edges for its tiles).  So ``indptr`` agrees with
  the JAX one on every row but the dummy's, whose row here is empty.
* The transpose CSR (edges sorted by (src, dst)) is stored, for the
  gather-only backward kernel.
* The bucketed ELL (``MultiEll``) is left out: it is a format for XLA on a
  TPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """Destination-sorted CSR plus its transpose, as int32 tensors.

    src:        (E,)  source of each edge, edges sorted by (dst, src).
    dst:        (E,)  destination of each edge (same order).
    indptr:     (N_pad + 1,) row pointers into ``src`` by destination.
    t_dst:      (E,)  destination of each edge, edges sorted by (src, dst).
    t_indptr:   (N_pad + 1,) row pointers into ``t_dst`` by source.
    in_degree / out_degree: (N_pad,) over the real edges.
    """

    src: torch.Tensor
    dst: torch.Tensor
    indptr: torch.Tensor
    t_dst: torch.Tensor
    t_indptr: torch.Tensor
    in_degree: torch.Tensor
    out_degree: torch.Tensor
    n_nodes: int          # padded node count N_pad
    n_real_nodes: int
    n_edges: int

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        fields = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **fields)


def _csr(rows: np.ndarray, cols: np.ndarray, n: int):
    """Sort (rows, cols) by (row, col); return (rows, cols, indptr)."""
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return rows, cols, indptr


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    *,
    add_self_loops: bool = False,
    node_multiple: int = 128,
    device: Optional[torch.device] = None,
) -> Graph:
    """Host-side graph construction (``dgl.graph + dgl.add_self_loop``)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if add_self_loops:
        loops = np.arange(n_nodes, dtype=np.int64)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    # +1 guarantees a dedicated dummy node even when n_nodes is already a
    # multiple of node_multiple.
    n_pad = _round_up(n_nodes + 1, node_multiple)
    n_edges = len(src)
    if n_edges >= 2**31 or n_pad >= 2**31:
        raise ValueError("graph too large for int32 CSR indices")

    dst_s, src_s, indptr = _csr(dst, src, n_pad)
    t_src, t_dst, t_indptr = _csr(src, dst, n_pad)
    del t_src

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    return Graph(
        src=i32(src_s),
        dst=i32(dst_s),
        indptr=i32(indptr),
        t_dst=i32(t_dst),
        t_indptr=i32(t_indptr),
        in_degree=i32(np.bincount(dst, minlength=n_pad)),
        out_degree=i32(np.bincount(src, minlength=n_pad)),
        n_nodes=n_pad,
        n_real_nodes=n_nodes,
        n_edges=n_edges,
    )


def from_scipy_coo(mat, **kwargs) -> Graph:
    """Build a Graph from a scipy sparse matrix (``dgl.graph((row, col))``)."""
    coo = mat.tocoo()
    return build_graph(coo.row, coo.col, mat.shape[0], **kwargs)


def pad_features(x: np.ndarray, n_pad_nodes: int) -> np.ndarray:
    """Zero-pad a (N, F) feature matrix to the padded node count."""
    n, f = x.shape
    out = np.zeros((n_pad_nodes, f), x.dtype)
    out[:n] = x
    return out
