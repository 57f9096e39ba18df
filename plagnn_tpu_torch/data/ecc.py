"""Edge clustering coefficients (ECC).

Port of ``plagnn_tpu/data/ecc.py``.  The reference computes, per undirected
edge (i, j):
    ecc_ij = #common-neighbors(i, j) / (min(deg_i, deg_j) - 1)
(epsilon when the denominator is 0) with an O(E·N) dense-row loop
(data_preprocess.py:175-214).  The JAX package counts the common
neighbours with a sorted merge on the host (or scipy's A·A); here the
counts come from ``ops/common_neighbors.py`` (the CUDA kernel
``csrc/common_neighbors.cu`` on a card, its plain version on the CPU),
and the ratio and the doubled COO are the JAX package's host float64
arithmetic, so every saved array equals the JAX one.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.common_neighbors import common_neighbors
from ..ops.pcc_scan import csr_tensors


def edge_clustering_coefficients(ppi_net, epsilon: float = 0.0, *,
                                 device="cuda") -> sp.coo_matrix:
    """ECC with reference semantics, the triangle counts on ``device``.

    The reference counts common neighbors with ``logical_and`` over 0/1
    rows -- for a binary symmetric adjacency that equals (A @ A)_ij.
    """
    a = ppi_net.tocsr().astype(np.float64)
    a.data[:] = 1.0  # ensure binary
    deg = np.asarray(a.sum(axis=1)).ravel()

    coo = sp.triu(a, k=1).tocoo()
    rows, cols = coo.row, coo.col

    tri = common_neighbors(csr_tensors(a, device),
                           torch.as_tensor(rows.astype(np.int32), device=device),
                           torch.as_tensor(cols.astype(np.int32), device=device))
    tri = tri.cpu().numpy().astype(np.float64)

    den = np.minimum(deg[rows], deg[cols]) - 1.0
    val = np.where(den > 0, tri / np.maximum(den, 1.0), epsilon)

    ecc = sp.coo_matrix(
        (
            np.concatenate([val, val]),
            (np.concatenate([rows, cols]), np.concatenate([cols, rows])),
        ),
        shape=a.shape,
    )
    return ecc


def edge_clustering_coefficients_dense_reference(
    ppi_net, epsilon: float = 0.0
) -> sp.coo_matrix:
    """Direct port of the reference O(E·N) loop (data_preprocess.py:175-214)
    -- used only to cross-check the fast path in tests."""
    ppi = ppi_net.tocsr()
    ecc_row, ecc_col, ecc_data = [], [], []
    for i in range(ppi.shape[0]):
        i_data = ppi[i].toarray()
        neighbors = ppi[i].indices
        degree_i = ppi[i].data.sum()
        for j in neighbors[neighbors > i]:
            j_data = ppi[j].toarray()
            triangles_num = np.logical_and(i_data, j_data).sum()
            degree_j = ppi[j].data.sum()
            possibly = min(degree_i, degree_j) - 1
            value = epsilon if possibly == 0 else triangles_num / possibly
            ecc_row += [i, j]
            ecc_col += [j, i]
            ecc_data += [value, value]
    return sp.coo_matrix((ecc_data, (ecc_row, ecc_col)), shape=ppi.shape)
