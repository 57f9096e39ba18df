"""Co-expression (PCC) factors of the expression matrices.

Port of ``plagnn_tpu/data/expression.py``'s factor form: ``pcc_factors``
returns Z with zero-mean unit-norm rows (zero rows for proteins without
variance) such that PCC = Z·Zᵀ with the diagonal taken as 0, so the
perturbation-topology step and the statistics work from the k-column
factors instead of dense N x N PCC matrices.  Each function has a numpy
form (float64, as the JAX package computes it on the host) and a torch
form (float64 on a given device).

``align_expression`` reads the expression CSV as the JAX package's pandas
code does (``read_csv``, a stable sort by ``uniprot_id``, the group mean,
``isin``, zero fill) on the ``csv`` module (``csv_values.py``), so
``expr_*.npy`` is bit for bit the JAX package's: the group mean is pandas'
compensated (Kahan) sum over a group's rows in file order (pyarrow's sort
is stable), skipping missing values, divided by their count; a group with
no value in a column gives NaN there.
"""
from __future__ import annotations

import csv
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .csv_values import NA_STRINGS, numeric_column


def read_csv_columns(csv_path: str, names: Sequence[str]) -> Dict[str, List[str]]:
    """The raw fields of the named columns, blank lines skipped."""
    with open(csv_path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header = rows[0]
    missing = [c for c in names if c not in header]
    if missing:
        raise KeyError(f"{csv_path}: no column {missing}")
    at = {c: header.index(c) for c in names}
    return {c: [r[at[c]] if at[c] < len(r) else "" for r in rows[1:]] for c in names}


def _group_means(keys: np.ndarray, values: np.ndarray, n_groups: int) -> np.ndarray:
    """pandas' groupby mean: per group and column, a compensated sum of
    the non-NaN values in row order, divided by their count (NaN where
    there is none).  Rows of one rank within their groups go together."""
    k = values.shape[1]
    sumx = np.zeros((n_groups, k))
    comp = np.zeros((n_groups, k))
    nobs = np.zeros((n_groups, k), np.int64)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    first = np.searchsorted(sorted_keys, sorted_keys, side="left")
    rank = np.arange(len(order)) - first
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        rows = order[rank == r]
        g = keys[rows]
        val = values[rows]
        ok = ~np.isnan(val)
        y = val - comp[g]
        t = sumx[g] + y
        c = t - sumx[g] - y
        c[np.isnan(c)] = 0.0
        comp[g] = np.where(ok, c, comp[g])
        sumx[g] = np.where(ok, t, sumx[g])
        nobs[g] += ok
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(nobs > 0, sumx / np.maximum(nobs, 1), np.nan)


def align_expression(
    csv_path: str, sample_list: Sequence[str], protein_list: Sequence[str]
) -> np.ndarray:
    """(N, k) expression matrix aligned to the PPI protein list (zeros for
    proteins absent from the CSV; a protein's probes averaged), as the JAX
    package's pandas code computes it (data_preprocess.py:139-165)."""
    fields = read_csv_columns(csv_path, ["uniprot_id", *sample_list])
    values = np.zeros((len(fields["uniprot_id"]), len(sample_list)))
    for c, s in enumerate(sample_list):
        values[:, c] = numeric_column(fields[s], coerce=False)
    index = {u: i for i, u in enumerate(protein_list)}
    keys = np.array([-1 if u in NA_STRINGS else index.get(u, -1)
                     for u in fields["uniprot_id"]], np.int64)
    keep = keys >= 0
    out = np.zeros((len(protein_list), len(sample_list)), np.float64)
    means = _group_means(keys[keep], values[keep], len(protein_list))
    present = np.zeros(len(protein_list), bool)
    present[keys[keep]] = True
    out[present] = means[present]
    return out


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


def pcc_dense(expr: np.ndarray) -> np.ndarray:
    """Dense PCC with reference post-processing (corrcoef -> zero diagonal
    -> NaN -> 0), data_preprocess.py:166-169; host numpy, as in the JAX
    package."""
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.corrcoef(expr)
    np.fill_diagonal(p, 0)
    p[np.isnan(p)] = 0
    return p


def construct_gcn_matrix(
    csv_path: str, sample_list: Sequence[str], protein_list: Sequence[str]
) -> Tuple[sp.coo_matrix, np.ndarray]:
    """(gcn coo, expr matrix) with exact reference semantics
    (data_preprocess.py:128-172)."""
    expr = align_expression(csv_path, sample_list, protein_list)
    gcn = sp.coo_matrix(pcc_dense(expr))
    return gcn, expr
