"""Padded CSR graph container for the aggregation kernels.

Port of ``plagnn_tpu/ops/graph_format.py:307-403`` (``build_graph``,
``from_scipy_coo``, ``pad_features``).  Node padding is the JAX package's:
``n_pad = round_up(n + 1, 128)``, so a dummy node at ``n_pad - 1`` always
exists, and explicit self-loops are appended when asked (with edge value
1.0 where the graph has edge values).  Edges are sorted
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
* The positional argmax (``build_pallas_graph(positional=...)``; here
  ``build_graph``'s, on by default past 2^15 padded nodes) keeps the JAX
  package's rule, with
  another layout for the rows past the rank cap: a row's argmax is the
  rank of the first maximum within the row, and a mega row (more than
  ``POS_RANK_CAP`` in-edges) stores that rank modulo the cap, its segment
  ``rank // cap`` going to a side table of one row per mega row (the
  JAX package moves the row's edges to sub-rows in spare padding slots).
  ``t_rank`` gives each transpose edge its forward rank, so the backward
  tests ranks and reads no node id; the argmax stays int16 at any size.
* The hub cache (``build_blocked_csr(hub_k)``'s ``HubStream``; here
  ``HubTable``, ``build_graph(hub_k=, hub_k_bwd=)`` or ``Graph.with_hub``)
  keeps the JAX choice of rows, the k most-fetched sources of a direction,
  but no second edge stream: a hub edge stays in its place in the (dst,
  src) order, and its index names an arena slot in place of a node.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


# The most edges one chunk of a row holds (the kernels' serial walk).
ROW_CHUNK = 256
# Positional argmax: the most in-edges a row may have before its rank is
# cut into (segment, rank in segment), so that a rank fits int16.
# Module-level so that tests reach the mega-row layout on small graphs
# (plagnn_tpu/ops/pallas/spmm_kernels.py: POS_RANK_CAP).
POS_RANK_CAP = (1 << 15) - 1


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
    order:     (C,)     the launch order of the max kernels' grouped walk
                        (narrow K-slices, several chunks a warp): the
                        chunks by edge count, longest first (ties in
                        chunk order), so the chunks of one warp end
                        together.  Each chunk writes only its own row or
                        slot, so the order changes no result; the 32-lane
                        walks and the hub kernels take chunk order.
    """

    row: torch.Tensor
    ptr: torch.Tensor
    slot: torch.Tensor
    split_row: torch.Tensor
    split_ptr: torch.Tensor
    order: torch.Tensor
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

    order = np.argsort(-np.diff(ptr), kind="stable")
    return RowChunks(row=i32(row), ptr=i32(ptr), slot=i32(slot),
                     split_row=i32(split_row), split_ptr=i32(split_ptr),
                     order=i32(order), cap=cap, n_slots=int(split_ptr[-1]))


def _to_device(obj, device):
    """A copy of a frozen dataclass with its tensors on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), (torch.Tensor, RowChunks, HubTable))})


@dataclasses.dataclass(frozen=True)
class HubTable:
    """One direction's hub cache: the ``k`` most-fetched rows of the
    gathered operand, read by the hub kernels from a shared-memory arena in
    place of device memory (``plagnn_tpu/ops/pallas/spmm_kernels.py:
    HubStream``, ``build_blocked_csr(hub_k)`` :384-415).

    ids:   (k,)  int32 node id of each arena slot: the rows by descending
           fetch count (ties to the lower id), rows fetched by no edge
           dropped, padded with the dummy node ``N_pad - 1`` -- the JAX
           package's ``HubStream.ids[:k]`` for the same edges.
    idx:   (E,)  int32 the direction's neighbour index (``Graph.src``
           forward, ``Graph.t_dst`` transpose) with each hub edge's entry
           replaced by ``-1 - slot``.
    n_hub: slots that hold a fetched row; the rest hold the dummy.
    n_covered: edges whose row the arena serves.

    The map from an edge to its slot is folded into the index the kernels
    already load, 32 edges at a time, and shuffle to the warp: a hub edge
    costs no byte and no load beyond the kernel without the hub (a per-edge
    int16 slot array would add 2 bytes and a load per 32 edges; a per-node
    ``slot_of`` one more dependent gather a chunk).  The max forward reads
    ``ids`` once a chunk to store a hub edge's source as the argmax.
    """

    ids: torch.Tensor
    idx: torch.Tensor
    k: int
    n_hub: int
    n_covered: int

    def to(self, device) -> "HubTable":
        return _to_device(self, device)


def hub_table(nbr: np.ndarray, n_pad: int, k: int, device=None) -> HubTable:
    """The hub table of k slots over one direction's neighbour index
    ``nbr`` (edges in that direction's CSR order)."""
    nbr = np.asarray(nbr, np.int64)
    fetch = np.bincount(nbr, minlength=n_pad)
    top = np.argsort(-fetch, kind="stable")[:k]
    top = top[fetch[top] > 0]
    ids = np.full(k, n_pad - 1, np.int64)
    ids[:len(top)] = top
    slot_of = np.full(n_pad, -1, np.int64)
    slot_of[top] = np.arange(len(top))
    slot = slot_of[nbr]

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    return HubTable(ids=i32(ids), idx=i32(np.where(slot >= 0, -1 - slot, nbr)), k=k,
                    n_hub=len(top), n_covered=int((slot >= 0).sum()))


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
    val / t_val: optional float32 (E,) edge values in the order of ``src``
                 and of ``t_dst`` (the weighted segment sum's).

    Positional argmax (``positional``; see the module docstring):
    t_rank:     (E,)  in the order of ``t_dst``: the edge's rank r within
                its forward destination row, or -1 - r where that row is a
                mega row (more than ``rank_cap`` in-edges).
    mega_of:    (N_pad,) mega row m's index m, -1 elsewhere; None where
                no row is a mega row.
    n_mega:     the number of mega rows, the side table's rows.

    Hub cache (``with_hub``): ``hub`` serves the forward (the max forward
    and the sum), ``t_hub`` the transpose (the max backward and the sum's
    VJP); None where that direction has none.

    norm_scales: GCN's degree scales by dtype, filled at first use
    (``spmm_kernels.gcn_scales``); not an argument, and a copy made by
    ``to`` or ``with_hub`` starts empty.
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
    val: Optional[torch.Tensor] = None
    t_val: Optional[torch.Tensor] = None
    positional: bool = False
    t_rank: Optional[torch.Tensor] = None
    mega_of: Optional[torch.Tensor] = None
    n_mega: int = 0
    rank_cap: int = POS_RANK_CAP
    hub: Optional[HubTable] = None
    t_hub: Optional[HubTable] = None
    norm_scales: Dict[torch.dtype, Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        return _to_device(self, device)

    def with_hub(self, k_fwd: int, k_bwd: int) -> "Graph":
        """This graph with a hub cache of ``k_fwd`` rows on the forward and
        ``k_bwd`` on the transpose (0: none), for a graph built before the
        run's configuration was known (``data/artifacts.py``).  A positional
        graph takes no hub, as in the JAX package
        (``build_pallas_graph``'s assertion, spmm_kernels.py:1784-1785)."""
        k_fwd, k_bwd = int(k_fwd), int(k_bwd)
        if k_fwd < 0 or k_bwd < 0:
            raise ValueError(f"hub sizes must be >= 0, got ({k_fwd}, {k_bwd})")
        if self.positional and (k_fwd or k_bwd):
            raise ValueError("the positional argmax takes no hub cache (as in the JAX "
                             "package); build the graph with positional=False")
        def table(nbr, k):
            return hub_table(nbr.cpu().numpy(), self.n_nodes, k, self.device) if k else None

        return dataclasses.replace(self, hub=table(self.src, k_fwd),
                                   t_hub=table(self.t_dst, k_bwd))


def _csr(rows: np.ndarray, cols: np.ndarray, n: int):
    """Sort (rows, cols) by (row, col); return (order, cols, indptr).  A
    stable sort of one int64 key a pair gives ``np.lexsort((cols,
    rows))``'s order, ties included, in half its time."""
    order = np.argsort(rows * n + cols, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return order, cols[order], indptr


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    *,
    add_self_loops: bool = False,
    node_multiple: int = 128,
    row_chunk: int = ROW_CHUNK,
    edge_val: Optional[np.ndarray] = None,
    positional: Optional[bool] = None,
    hub_k: int = 0,
    hub_k_bwd: int = 0,
    device: Optional[torch.device] = None,
) -> Graph:
    """Host-side graph construction (``dgl.graph + dgl.add_self_loop``);
    ``row_chunk`` is the most edges a chunk of ``chunks``/``t_chunks``
    holds; ``edge_val`` (one value per edge, float32) gives ``val`` and
    ``t_val``, sorted with the edges.  ``positional`` records the max's
    argmax as ranks within rows (``t_rank``, ``mega_of``); None turns it on
    exactly when N_pad > 2^15, as ``build_pallas_graph`` does.  ``hub_k`` /
    ``hub_k_bwd`` give the forward / transpose a hub cache of that many
    rows (``Graph.with_hub``; ``build_pallas_graph(hub_k=, hub_k_bwd=)``)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if edge_val is not None:
        edge_val = np.asarray(edge_val, np.float32)
        if edge_val.shape != src.shape:
            raise ValueError(f"edge_val must hold one value per edge, got "
                             f"{edge_val.shape} for {src.shape[0]} edges")
    if add_self_loops:
        loops = np.arange(n_nodes, dtype=np.int64)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
        if edge_val is not None:
            edge_val = np.concatenate([edge_val, np.ones(n_nodes, np.float32)])
    # +1 guarantees a dedicated dummy node even when n_nodes is already a
    # multiple of node_multiple.
    n_pad = _round_up(n_nodes + 1, node_multiple)
    n_edges = len(src)
    if n_edges >= 2**31 or n_pad >= 2**31:
        raise ValueError("graph too large for int32 CSR indices")

    order, src_s, indptr = _csr(dst, src, n_pad)
    t_order, t_dst, t_indptr = _csr(src, dst, n_pad)
    dst_s = dst[order]
    in_degree = np.diff(indptr)
    if positional is None:
        positional = n_pad > (1 << 15)     # node ids no longer fit int16

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

    pos = {}
    if positional:
        cap = POS_RANK_CAP
        if in_degree.max(initial=0) > (1 << 15) * cap:
            raise ValueError(f"a row of {in_degree.max()} in-edges has segments "
                             f"past int16 at rank cap {cap}")
        rank = np.empty(n_edges, np.int64)
        rank[order] = np.arange(n_edges) - indptr[dst_s]
        t_rank = rank[t_order]
        mega = np.flatnonzero(in_degree > cap)
        mega_of = None
        if len(mega):
            t_rank = np.where(in_degree[t_dst] > cap, -1 - t_rank, t_rank)
            mega_of = np.full(n_pad, -1, np.int64)
            mega_of[mega] = np.arange(len(mega))
            mega_of = i32(mega_of)
        pos = dict(positional=True, t_rank=i32(t_rank), mega_of=mega_of,
                   n_mega=len(mega), rank_cap=cap)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    graph = Graph(
        src=i32(src_s),
        dst=i32(dst_s),
        indptr=i32(indptr),
        t_dst=i32(t_dst),
        t_indptr=i32(t_indptr),
        in_degree=i32(in_degree),
        out_degree=i32(np.bincount(src, minlength=n_pad)),
        n_nodes=n_pad,
        n_real_nodes=n_nodes,
        n_edges=n_edges,
        chunks=chunk_table(indptr, row_chunk, device),
        t_chunks=chunk_table(t_indptr, row_chunk, device),
        val=None if edge_val is None else f32(edge_val[order]),
        t_val=None if edge_val is None else f32(edge_val[t_order]),
        **pos,
    )
    return graph.with_hub(hub_k, hub_k_bwd) if hub_k or hub_k_bwd else graph


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
