"""Node reorderings of a graph and how far each clusters a row's sources.

Port of ``plagnn_tpu/ops/reorder.py`` (host numpy and scipy, the same
results from the same inputs).  The JAX package reorders nodes so that the
Pallas kernels' G = 8-edge groups find strictly consecutive source ids and
fetch them with one wider DMA; ``group_runs`` counts such groups.  The CUDA
kernels here have no G-edge groups: a warp walks a row chunk's edges and
gathers each source row, served from L2 when it was read before.  So on this
card an ordering is measured by the kernels' time under it (``chip_smoke.py``
phase 4o times the max forward and the sum under the identity, RCM and
greedy orders); ``G`` stays the JAX kernel's group width so that
``group_runs`` and ``coalesce_report`` give the JAX package's numbers.

A permutation ``perm`` maps NEW id -> OLD id; features/labels/masks reorder
as ``x[perm]`` and results restore as ``out[inv_perm]``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

G = 8  # edges per group of the JAX Pallas kernel (plagnn_tpu/ops/pallas/spmm_kernels.G)


def relabel_edges(
    src: np.ndarray, dst: np.ndarray, perm: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Apply a NEW->OLD permutation to an edge list: node OLD gets id
    ``inv_perm[OLD]``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv[src], inv[dst]


def rcm_order(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (bandwidth-minimizing BFS), NEW->OLD."""
    a = sp.coo_matrix(
        (np.ones(len(src), np.int8), (src, dst)), shape=(n_nodes, n_nodes)
    ).tocsr()
    a = a + a.T
    return np.asarray(csgraph.reverse_cuthill_mckee(a, symmetric_mode=True), np.int64)


def greedy_coalesce_order(
    src: np.ndarray, dst: np.ndarray, n_nodes: int
) -> np.ndarray:
    """Destination-major consecutive assignment, NEW->OLD.

    Visit destinations by descending in-degree; append each destination's
    not-yet-assigned sources (ascending) to the ordering.  The hottest rows'
    source lists become contiguous id ranges wherever their members weren't
    already claimed by a hotter row; overlapping neighborhoods (community
    structure) then make many destinations' sources share the same
    contiguous members.
    """
    a = sp.coo_matrix(
        (np.ones(len(src), np.int8), (src, dst)), shape=(n_nodes, n_nodes)
    ).tocsc()
    a.sum_duplicates()
    indeg = np.diff(a.indptr)
    order_dst = np.argsort(-indeg, kind="stable")
    assigned = np.zeros(n_nodes, bool)
    perm = np.empty(n_nodes, np.int64)
    k = 0
    indptr, indices = a.indptr, a.indices
    for d in order_dst:
        for s in indices[indptr[d]:indptr[d + 1]]:
            if not assigned[s]:
                assigned[s] = True
                perm[k] = s
                k += 1
    rest = np.flatnonzero(~assigned)
    perm[k:] = rest
    return perm


def group_runs(
    src: np.ndarray, dst: np.ndarray
) -> tuple[int, int]:
    """(n_coalescible_groups, n_groups): how many G-edge groups of the
    (dst, src)-sorted, per-row G-padded edge list have strictly consecutive
    source ids (the JAX kernel's single-wide-DMA condition).  Each row's
    edge list is padded to a multiple of G with dummy slots, which break
    consecutiveness (counted not coalescible, to stay conservative)."""
    order = np.lexsort((src, dst))
    s, d = src[order], dst[order]
    counts = np.bincount(d)
    counts = counts[counts > 0]
    padded = ((counts + G - 1) // G) * G
    n_groups = int(padded.sum()) // G
    # positions of each edge inside its padded row
    row_end = np.cumsum(counts)
    row_start = row_end - counts
    pad_start = np.cumsum(padded) - padded
    pos = pad_start.repeat(counts) + (np.arange(len(s)) - row_start.repeat(counts))
    grid = np.full(n_groups * G, -(10 * G), np.int64)  # breaks any run
    grid[pos] = s
    grp = grid.reshape(-1, G)
    consec = (np.diff(grp, axis=1) == 1).all(axis=1)
    return int(consec.sum()), n_groups


def coalesce_report(
    src: np.ndarray, dst: np.ndarray, n_nodes: int
) -> dict:
    """Coalescible-group fraction under identity / RCM / greedy orderings,
    for both kernel directions (forward: groups share dst; backward:
    transpose groups share src)."""
    out = {}
    for name, perm in (
        ("identity", np.arange(n_nodes, dtype=np.int64)),
        ("rcm", rcm_order(src, dst, n_nodes)),
        ("greedy", greedy_coalesce_order(src, dst, n_nodes)),
    ):
        s, d = relabel_edges(src, dst, perm)
        cf, nf = group_runs(s, d)
        cb, nb = group_runs(d, s)
        out[name] = {
            "fwd": cf / max(nf, 1),
            "bwd": cb / max(nb, 1),
            "n_groups_fwd": nf,
        }
    return out
