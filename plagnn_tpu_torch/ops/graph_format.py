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
* Each CSR's rows are cut into chunks of at most ``ROW_CHUNK`` edges
  (``RowChunks``), the JAX mega-row split (``build_pallas_graph``'s
  ``rank // cap``) applied to every row of both directions, so that the
  row-chunked kernels (``csrc/row_chunks.cuh``) bound every thread's walk.
* The bucketed ELL (``MultiEll``) is left out: it is a format for XLA on a
  TPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


# The most edges one chunk of a row holds (the kernels' serial walk).
ROW_CHUNK = 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RowChunks:
    """One CSR's rows cut into consecutive runs of at most ``cap`` edges, in
    ascending edge order: chunk ``j`` of a row holds the edges of rank
    ``[j*cap, (j+1)*cap)``.  An empty row has one empty chunk.  int32.

    row:       (C,)     row of each chunk; chunks in (row, rank) order.
    ptr:       (C + 1,) chunk c holds the edges ``[ptr[c], ptr[c+1])``.
    slot:      (C,)     -1 where the chunk is its row's only one, else its
                        row in the (n_slots, K) float32 partial buffer.
    split_row: (S,)     the rows of more than ``cap`` edges, ascending.
    split_ptr: (S + 1,) split row i owns the slots
                        ``[split_ptr[i], split_ptr[i+1])``, in chunk order.
    """

    row: torch.Tensor
    ptr: torch.Tensor
    slot: torch.Tensor
    split_row: torch.Tensor
    split_ptr: torch.Tensor
    cap: int
    n_slots: int

    @property
    def n_chunks(self) -> int:
        return self.row.shape[0]

    @property
    def n_split(self) -> int:
        return self.split_row.shape[0]

    def to(self, device) -> "RowChunks":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def chunk_table(indptr: np.ndarray, cap: int, device=None) -> RowChunks:
    """The chunk table of the CSR with row pointers ``indptr``."""
    if cap < 1:
        raise ValueError(f"row chunk must be >= 1, got {cap}")
    indptr = np.asarray(indptr, np.int64)
    deg = np.diff(indptr)
    per_row = np.maximum(1, -(-deg // cap))
    row = np.repeat(np.arange(len(deg)), per_row)
    first = np.cumsum(per_row) - per_row          # each row's first chunk
    rank0 = (np.arange(len(row)) - first[row]) * cap
    ptr = np.append(indptr[row] + rank0, indptr[-1])
    split = deg > cap
    in_split = split[row]
    slot = np.where(in_split, np.cumsum(in_split) - 1, -1)
    split_row = np.flatnonzero(split)
    split_ptr = np.zeros(len(split_row) + 1, np.int64)
    np.cumsum(per_row[split_row], out=split_ptr[1:])

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    return RowChunks(row=i32(row), ptr=i32(ptr), slot=i32(slot),
                     split_row=i32(split_row), split_ptr=i32(split_ptr),
                     cap=cap, n_slots=int(split_ptr[-1]))


@dataclasses.dataclass(frozen=True)
class Graph:
    """Destination-sorted CSR plus its transpose, as int32 tensors.

    src:        (E,)  source of each edge, edges sorted by (dst, src).
    dst:        (E,)  destination of each edge (same order).
    indptr:     (N_pad + 1,) row pointers into ``src`` by destination.
    t_dst:      (E,)  destination of each edge, edges sorted by (src, dst).
    t_indptr:   (N_pad + 1,) row pointers into ``t_dst`` by source.
    in_degree / out_degree: (N_pad,) over the real edges.
    chunks / t_chunks: ``RowChunks`` of (indptr, src) and (t_indptr, t_dst).
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
    chunks: Optional[RowChunks] = None
    t_chunks: Optional[RowChunks] = None

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        fields = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (torch.Tensor, RowChunks))
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
    row_chunk: int = ROW_CHUNK,
    device: Optional[torch.device] = None,
) -> Graph:
    """Host-side graph construction (``dgl.graph + dgl.add_self_loop``);
    ``row_chunk`` is the most edges a chunk of ``chunks``/``t_chunks``
    holds."""
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
        chunks=chunk_table(indptr, row_chunk, device),
        t_chunks=chunk_table(t_indptr, row_chunk, device),
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
