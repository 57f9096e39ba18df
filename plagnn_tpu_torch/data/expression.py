"""Co-expression (PCC) factors of the expression matrices.

Port of ``plagnn_tpu/data/expression.py``'s factor form: ``pcc_factors``
returns Z with zero-mean unit-norm rows (zero rows for proteins without
variance) such that PCC = Z·Zᵀ with the diagonal taken as 0, so the
perturbation-topology step and the statistics work from the k-column
factors instead of dense N x N PCC matrices.  Each function has a numpy
form (float64, as the JAX package computes it on the host) and a torch
form (float64 on a given device).  ``align_expression`` and
``construct_gcn_matrix`` need pandas and come with the preprocess slice.
"""
from __future__ import annotations

import numpy as np
import torch


def pcc_factors(expr: np.ndarray) -> np.ndarray:
    """Standardized factors Z with PCC = Z·Zᵀ (diagonal excluded).

    Rows with zero variance (e.g. all-zero fill) become zero rows, matching
    corrcoef's NaN rows after the reference's NaN -> 0."""
    x = np.asarray(expr, np.float64)
    xc = x - x.mean(axis=1, keepdims=True)
    norm = np.sqrt((xc * xc).sum(axis=1, keepdims=True))
    with np.errstate(invalid="ignore", divide="ignore"):
        z = np.where(norm > 0, xc / norm, 0.0)
    return z


def pcc_factors_torch(expr, device) -> torch.Tensor:
    """:func:`pcc_factors` in float64 on ``device``."""
    x = torch.as_tensor(np.asarray(expr, np.float64), device=device)
    xc = x - x.mean(dim=1, keepdim=True)
    norm = torch.sqrt((xc * xc).sum(dim=1, keepdim=True))
    return torch.where(norm > 0, xc / norm, torch.zeros((), dtype=x.dtype, device=device))


def pcc_at_edges(z: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """PCC values at edge positions from factors (diagonal entries return the
    raw product; callers exclude them)."""
    return np.einsum("ek,ek->e", z[rows], z[cols])


def pcc_at_edges_torch(z: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """:func:`pcc_at_edges` on z's device, summed over t = 0..k-1 in
    ascending order with one rounding per product and per sum: the
    arithmetic of ``csrc/pcc_diff_scan.cu``, so an edge's ΔPCC equals the
    scan's value at that pair."""
    a, b = z[rows], z[cols]
    acc = a[:, 0] * b[:, 0]
    for t in range(1, z.shape[1]):
        acc = acc + a[:, t] * b[:, t]
    return acc
