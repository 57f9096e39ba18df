"""Destination-block graph partition with halo tables.

Port of ``plagnn_tpu/parallel/partition.py`` (``partition_graph``,
``shard_features``, ``unshard_rows``).  The host tables are the JAX
package's, built the same way in numpy: P ranks along the mesh's graph axis
each own C consecutive rows (C = ceil(N / P) rounded up to
``node_multiple``) with their in-edges, and each rank's local gather space
is

    [own C rows | P * S halo slots | padding],

where halo slot (q, k), at position C + q*S + k, receives row
``send_idx[q, p, k]`` of rank q (-1 pads), S the largest number of rows one
rank needs from another, rounded up to 8.  Max and sum compose across the
cut, so each rank aggregates its own rows exactly; the halo slots hold
copies of remote rows, not partial results, so the argmax-routed backward
stays local.

With ``balance`` the nodes are dealt to the blocks in snake order of
descending in-degree before the cut, so every rank owns about E/P in-edges
(a power-law PPI's hubs cluster in id order); ``row_map`` / ``node_row``
record the permutation.

The hub cache (``Graph.with_hub``; JAX ``_stack_pallas_graphs(hub_k,
hub_k_bwd)``): ``shard(rank, device, hub_k, hub_k_bwd)`` gives the rank's
interior graph the k most-fetched rows of each direction, the JAX
package's per-chip ``HubStream.ids[r][:k]`` (``pallas_interior`` with
overlap, ``pallas_local`` on a graph axis of size 1, where the interior
holds every edge), and its boundary graph none: the boundary stream is
small, so its hub would not pay for itself (JAX ``partition_graph``).
Interior sources are own rows, so every hub id is below C.  JAX stacks the
P tables and pads them to the longest for ``shard_map``; here each rank
builds its own table and only its shard goes to its device.

What the port leaves out: the stacked per-chip ``Graph`` pytrees with their
bucketed ELL and the ``pallas_*`` DMA-kernel layouts, TPU formats with no
Hopper counterpart.  ``PartitionedGraph.shard`` builds one rank's interior
and boundary CSR ``Graph``s with their row-chunk tables instead.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.graph_format import Graph, build_graph

# Padded node count of every shard's gather space: round_up(C + P*S + 1, 8),
# the JAX package's multiple when it builds no Pallas layout.
NODE_PAD = 8

Edges = Tuple[np.ndarray, np.ndarray]   # (local src, local dst), int64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's part of a ``PartitionedGraph``, on its device.

    interior / boundary: the rank's edges over its gather space whose
                source is an own row / a halo slot; the interior holds the
                self-loops (on a graph axis of size 1, every edge).
    send_idx:   (P, S) int32, the own rows this rank sends to each peer's
                halo (-1 pads).
    in_degree / out_degree: (C,) int32 global degrees of the own rows.
    """

    rank: int
    own_rows: int
    interior: Graph
    boundary: Graph
    send_idx: torch.Tensor
    in_degree: torch.Tensor
    out_degree: torch.Tensor

    @property
    def n_nodes(self) -> int:
        """Rows of the gather space (padded)."""
        return self.interior.n_nodes


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Host tables of a destination-block partition over P ranks.

    send_idx:   (P, P, S) int32; send_idx[p, q, k] is the own row rank p
                sends to rank q's k-th halo slot from p (-1 = none).
    in_degree / out_degree: (P, C) int32 global degrees of owned rows.
    row_map / node_row: the balanced permutation (None: identity, rows
                [0, n_real) are node ids); row_map (P*C,) gives the node in
                each global row (-1 = padding), node_row (n_real,) each
                node's global row.
    local_edges / interior_edges / boundary_edges: per rank, the (src, dst)
                local ids of its edges in the gather space [own | halo];
                the split is None without ``overlap`` (the JAX package's
                tables; ``shard`` needs the split).
    """

    send_idx: np.ndarray
    in_degree: np.ndarray
    out_degree: np.ndarray
    n_chips: int
    own_rows: int
    halo_per_peer: int
    n_real_nodes: int
    n_edges: int
    local_edges: List[Edges]
    interior_edges: Optional[List[Edges]] = None
    boundary_edges: Optional[List[Edges]] = None
    row_map: Optional[np.ndarray] = None
    node_row: Optional[np.ndarray] = None

    @property
    def n_local(self) -> int:
        """Own rows plus halo slots: C + P*S."""
        return self.own_rows + self.n_chips * self.halo_per_peer

    @property
    def n_pad(self) -> int:
        """Rows of every shard's padded gather space (``Shard.n_nodes``)."""
        return _round_up(self.n_local + 1, NODE_PAD)

    def shard(self, rank: int, device=None, hub_k: int = 0, hub_k_bwd: int = 0) -> Shard:
        """Rank ``rank``'s interior and boundary graphs (with their row-chunk
        tables), halo table and degrees, built on the host and moved to
        ``device``; the interior with a hub of ``hub_k`` rows forward and
        ``hub_k_bwd`` on the transpose (0: none), the boundary with none."""
        if not 0 <= rank < self.n_chips:
            raise ValueError(f"rank {rank} outside the {self.n_chips} graph ranks")
        if self.interior_edges is None:
            raise ValueError("a shard runs its interior and boundary passes: "
                             "partition with overlap=True")

        def graph(edges, kf=0, kb=0):
            # id-based argmax at any size, as the JAX package's sharded path
            # keeps it: a shard's passes take empty_value=-inf
            s, d = edges[rank]
            return build_graph(s, d, self.n_local, node_multiple=NODE_PAD,
                               positional=False, hub_k=kf, hub_k_bwd=kb).to(device)

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

        return Shard(
            rank=rank,
            own_rows=self.own_rows,
            interior=graph(self.interior_edges, hub_k, hub_k_bwd),
            boundary=graph(self.boundary_edges),
            send_idx=i32(self.send_idx[rank]),
            in_degree=i32(self.in_degree[rank]),
            out_degree=i32(self.out_degree[rank]),
        )


def snake_rows(degree: np.ndarray, p: int, c: int) -> np.ndarray:
    """The balanced node -> row relabelling: nodes sorted by descending
    degree (stable: hubs first, ties by id) and dealt snake-wise over p
    blocks of c rows.  Returns node_row (n,), int64.  ``partition_graph``
    deals its blocks with it (by in-degree) and the mesh planner counts its
    halos on it."""
    n = len(degree)
    order = np.argsort(-degree, kind="stable")
    k = np.arange(n)
    rnd, j = k // p, k % p
    block = np.where(rnd % 2 == 0, j, p - 1 - j)
    node_row = np.empty(n, np.int64)
    node_row[order] = block * c + rnd
    return node_row


def partition_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n_real: int,
    n_chips: int,
    *,
    add_self_loops: bool = False,
    node_multiple: int = 8,
    overlap: bool = True,
    balance: bool = False,
) -> PartitionedGraph:
    """Host-side 1-D destination-block partitioner (the JAX package's
    tables; see the module docstring).  ``overlap`` also splits each rank's
    edges into interior and boundary sets, so the interior pass can run
    while the halo is exchanged."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if add_self_loops:
        loops = np.arange(n_real, dtype=np.int64)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])

    p = int(n_chips)
    c = _round_up(-(-n_real // p), node_multiple)  # own rows per rank

    row_map = node_row = None
    if balance:
        node_row = snake_rows(np.bincount(dst, minlength=n_real).astype(np.int64), p, c)
        row_map = np.full(p * c, -1, np.int32)
        row_map[node_row] = np.arange(n_real)
        # every endpoint into row space: the block math below works on rows
        src = node_row[src]
        dst = node_row[dst]

    in_deg = np.bincount(dst, minlength=p * c).astype(np.int32)
    out_deg = np.bincount(src, minlength=p * c).astype(np.int32)
    owner_dst = dst // c
    owner_src = src // c

    # One sorted unique pass over the cross-owner edges gives every
    # (consumer, owner) group's needed source rows; an edge's slot is a
    # searchsorted against the same table.
    cross = owner_src != owner_dst
    trip = np.unique(
        np.stack([owner_dst[cross], owner_src[cross], src[cross]], axis=1),
        axis=0,
    ).reshape(-1, 3)  # sorted rows: (consumer, owner, global src)
    grp_key = trip[:, 0] * p + trip[:, 1]
    bounds = np.searchsorted(grp_key, np.arange(p * p + 1))
    s_max = max(int(np.diff(bounds).max()) if len(trip) else 0, 1)
    s_pad = _round_up(s_max, 8)

    send_idx = np.full((p, p, s_pad), -1, np.int32)
    for pp in range(p):
        for q in range(p):
            lo, hi = bounds[pp * p + q], bounds[pp * p + q + 1]
            if q != pp and lo < hi:
                send_idx[q, pp, : hi - lo] = trip[lo:hi, 2] - q * c

    # Each edge's source in its consumer's gather space: own edges into the
    # own block, cross edges to halo base + owner block + slot in the group.
    n_key = int(src.max()) + 1 if len(src) else 1
    key_trip = grp_key * n_key + trip[:, 2]
    key_edge = (owner_dst[cross] * p + owner_src[cross]) * n_key + src[cross]
    slot = (np.searchsorted(key_trip, key_edge)
            - bounds[owner_dst[cross] * p + owner_src[cross]])
    s_l = np.empty_like(src)
    s_l[~cross] = src[~cross] - owner_dst[~cross] * c
    s_l[cross] = c + owner_src[cross] * s_pad + slot
    d_l = dst - owner_dst * c

    order_e = np.argsort(owner_dst, kind="stable")
    rank_bounds = np.searchsorted(owner_dst[order_e], np.arange(p + 1))
    local = [(s_l[order_e[rank_bounds[r]:rank_bounds[r + 1]]],
              d_l[order_e[rank_bounds[r]:rank_bounds[r + 1]]]) for r in range(p)]
    interior = boundary = None
    if overlap:
        interior = [(s[s < c], d[s < c]) for s, d in local]
        boundary = [(s[s >= c], d[s >= c]) for s, d in local]

    return PartitionedGraph(
        send_idx=send_idx,
        in_degree=in_deg.reshape(p, c),
        out_degree=out_deg.reshape(p, c),
        n_chips=p,
        own_rows=c,
        halo_per_peer=s_pad,
        n_real_nodes=n_real,
        n_edges=len(src),
        local_edges=local,
        interior_edges=interior,
        boundary_edges=boundary,
        row_map=row_map,
        node_row=None if node_row is None else node_row.astype(np.int32),
    )


def shard_features(x: np.ndarray, pgraph: PartitionedGraph) -> np.ndarray:
    """(N, F) host rows -> (P, C, F) owner-block shards (zero padded),
    through the balanced permutation when one is recorded."""
    p, c = pgraph.n_chips, pgraph.own_rows
    x = np.asarray(x)
    out = np.zeros((p * c, x.shape[1]), x.dtype)
    if pgraph.row_map is not None:
        valid = pgraph.row_map >= 0
        out[valid] = x[pgraph.row_map[valid]]
    else:
        out[: len(x)] = x
    return out.reshape(p, c, x.shape[1])


def unshard_rows(x: np.ndarray, pgraph: PartitionedGraph) -> np.ndarray:
    """(P, C, F) shards -> (N_real, F), undoing any balanced permutation."""
    p, c = pgraph.n_chips, pgraph.own_rows
    flat = np.asarray(x).reshape(p * c, -1)
    if pgraph.node_row is not None:
        return flat[pgraph.node_row]
    return flat[: pgraph.n_real_nodes]
