"""Perturbation-topology adjustment without dense N² intermediates.

Port of ``plagnn_tpu/data/topology.py``, which reproduces the reference's
``modify_network_topology`` (data_preprocess.py:217-257): with diff =
PCC_inter - PCC_normal (dense, zero diagonal, NaN rows zeroed) and the
thresholds mean ± thr·std over the FULL dense matrix (zeros included),
remove existing edges where diff < lo and add absent pairs where diff > hi.

The mean and std come from closed-form k x k Gram identities over the
standardized factors Z (PCC = Z·Zᵀ), in float64 on the device; the
existing edges' diffs are O(E·k) products on the device; the absent pairs
above hi come from the ΔPCC hit scan (``ops/pcc_scan.py``, the CUDA kernel
``csrc/pcc_diff_scan.cu`` on a card).  ``_modify_dense`` is the
reference's dense path in numpy, the tests' oracle.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.pcc_scan import csr_tensors, pcc_diff_hits
from .expression import pcc_at_edges_torch


def _dense_sum_stats(z_a: torch.Tensor, z_b: torch.Tensor) -> Tuple[float, float]:
    """(Σ diff, Σ diff²) over the full dense diff = A - B, A = Za·Zaᵀ,
    B = Zb·Zbᵀ, both with diagonals forced to 0."""
    va = (z_a * z_a).sum(1)  # 1 for valid rows, else 0
    vb = (z_b * z_b).sum(1)
    s_a = z_a.sum(0)
    s_b = z_b.sum(0)
    sum_a = s_a @ s_a - va.sum()
    sum_b = s_b @ s_b - vb.sum()
    gaa = z_a.T @ z_a
    gbb = z_b.T @ z_b
    gab = z_a.T @ z_b
    sq_a = (gaa * gaa).sum() - (va * va).sum()
    sq_b = (gbb * gbb).sum() - (vb * vb).sum()
    cross = (gab * gab).sum() - (va * vb).sum()
    s1, s2 = torch.stack([sum_a - sum_b, sq_a - 2.0 * cross + sq_b]).tolist()
    return s1, s2


def diff_stats(z_inter: torch.Tensor, z_nor: torch.Tensor) -> Tuple[float, float]:
    """(mean, std) of the dense difference matrix, as np.mean / np.std over
    the materialized matrix (ddof=0), from float64 factors on any device."""
    n = z_inter.shape[0]
    total = float(n) * float(n)
    s1, s2 = _dense_sum_stats(z_inter, z_nor)
    mean = s1 / total
    var = s2 / total - mean * mean
    return mean, float(np.sqrt(max(var, 0.0)))


def modify_network_topology(
    ppi_net,
    pcc_nor,
    pcc_inter,
    thr: float,
    *,
    device="cuda",
) -> sp.coo_matrix:
    """Reference-semantics topology adjustment, as a COO matrix of ones:
    the kept edges in the PPI's stored order, then the added pairs in
    row-major order (the JAX factor path's order).

    pcc_nor / pcc_inter are the (N, k) factor matrices of
    ``expression.pcc_factors`` (numpy arrays or tensors), moved to
    ``device`` in float64."""
    ppi = ppi_net.tocsr().astype(np.int8)
    n = ppi.shape[0]
    z_i = torch.as_tensor(pcc_inter, dtype=torch.float64, device=device).contiguous()
    z_n = torch.as_tensor(pcc_nor, dtype=torch.float64, device=device).contiguous()

    mean, std = diff_stats(z_i, z_n)
    lo = mean - thr * std
    hi = mean + thr * std

    # existing edges: O(E·k) diffs on the device; remove where diff < lo
    coo = ppi.tocoo()
    er = torch.as_tensor(coo.row.astype(np.int64), device=z_i.device)
    ec = torch.as_tensor(coo.col.astype(np.int64), device=z_i.device)
    ediff = pcc_at_edges_torch(z_i, er, ec) - pcc_at_edges_torch(z_n, er, ec)
    keep = (~(ediff < lo)).cpu().numpy()
    kept_r, kept_c = coo.row[keep], coo.col[keep]

    # absent pairs with diff > hi, row-major
    add_r, add_c = pcc_diff_hits(z_i, z_n, hi, csr_tensors(ppi, z_i.device))
    new_r = np.concatenate([kept_r.astype(np.int64), add_r.cpu().numpy().astype(np.int64)])
    new_c = np.concatenate([kept_c.astype(np.int64), add_c.cpu().numpy().astype(np.int64)])
    return sp.coo_matrix(
        (np.ones(len(new_r), np.int64), (new_r, new_c)), shape=(n, n))


def _modify_dense(ppi, pcc_nor, pcc_inter, thr) -> sp.coo_matrix:
    """Direct port of the reference dense path (data_preprocess.py:228-257),
    the test oracle."""
    a = np.asarray(pcc_inter.todense() if sp.issparse(pcc_inter) else pcc_inter,
                   np.float64)
    b = np.asarray(pcc_nor.todense() if sp.issparse(pcc_nor) else pcc_nor,
                   np.float64)
    diff = a - b
    ppi_d = np.asarray(ppi.todense())
    lo = diff.mean() - thr * diff.std()
    hi = diff.mean() + thr * diff.std()
    res1 = np.logical_and(diff < lo, ppi_d == 1)
    res2 = np.logical_and(diff > hi, ppi_d == 0)
    out = ppi_d.copy()
    out[res1] = 0
    out[res2] = 1
    return sp.coo_matrix(out)
