"""Synthetic PPI-like data generation.

The reference's real inputs (BioGRID mitab, GEO expression CSVs, UniProt dat)
are stripped from the repo (`.MISSING_LARGE_BLOBS`, SURVEY.md "scale
caveat"), so tests and benchmarks run on synthetic graphs with the same
statistical shape: power-law degree PPI adjacency (symmetric, zero diagonal),
503-dim features (3 expr + 250 GCN-PCA + 250 ECC-PCA, utils.py:46-49) and a
sparse multi-label 12-class localization matrix.  The 10M-edge configuration
of BASELINE.json's scaling sweep uses the same generator.

This is the port's own copy of ``plagnn_tpu/data/synthetic.py`` (numpy and
scipy only): the same seed gives bit-identical output in both packages.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def powerlaw_ppi(
    n_nodes: int,
    n_edges: int,
    seed: int = 70,
    gamma: float = 2.2,
) -> sp.coo_matrix:
    """Symmetric 0/1 adjacency with a power-law degree profile, zero diagonal
    (matching construct_uniprot_ppi output, data_preprocess.py:74-110).

    Configuration-model style: endpoints sampled ∝ a zipf-ish weight,
    duplicate and self edges removed; n_edges counts *directed* edges after
    symmetrization (approximately).
    """
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n_nodes + 1, dtype=np.float64)) ** (-1.0 / (gamma - 1.0))
    w /= w.sum()
    m = n_edges // 2
    # oversample to compensate dedup/self-loop removal
    k = int(m * 1.3) + 16
    a = rng.choice(n_nodes, size=k, p=w)
    b = rng.choice(n_nodes, size=k, p=w)
    keep = a != b
    a, b = a[keep], b[keep]
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)
    if len(pairs) > m:
        pairs = pairs[rng.choice(len(pairs), size=m, replace=False)]
    row = np.concatenate([pairs[:, 0], pairs[:, 1]])
    col = np.concatenate([pairs[:, 1], pairs[:, 0]])
    data = np.ones(len(row), np.int8)
    return sp.coo_matrix((data, (row, col)), shape=(n_nodes, n_nodes))


def synthetic_features(
    n_nodes: int,
    seed: int = 70,
    n_expr: int = 3,
    n_gcn: int = 250,
    n_ecc: int = 250,
) -> np.ndarray:
    """(N, 503) float32 feature matrix with the reference's block structure."""
    rng = np.random.default_rng(seed + 1)
    expr = rng.gamma(2.0, 2.0, size=(n_nodes, n_expr))
    gcn = rng.standard_normal((n_nodes, n_gcn)) * 0.5
    ecc = rng.standard_normal((n_nodes, n_ecc)) * 0.3
    return np.hstack([expr, gcn, ecc]).astype(np.float32)


def synthetic_loc_matrix(
    n_nodes: int,
    seed: int = 70,
    n_classes: int = 12,
    labeled_frac: float = 0.6,
) -> Tuple[sp.coo_matrix, list]:
    """(loc_matrix, label_with_loc_list): imbalanced multi-label annotations
    over ~labeled_frac of the nodes (the CV universe,
    data_preprocess.py:457-472)."""
    rng = np.random.default_rng(seed + 2)
    class_p = np.geomspace(0.35, 0.01, n_classes)
    labeled = rng.random(n_nodes) < labeled_frac
    labels = rng.random((n_nodes, n_classes)) < class_p[None, :]
    labels &= labeled[:, None]
    # every labeled node gets ≥1 annotation
    need = labeled & (labels.sum(1) == 0)
    labels[need, rng.integers(0, 3, size=int(need.sum()))] = True
    # every class gets ≥1 annotation (weight_cal divides by class counts)
    for c in range(n_classes):
        if labels[:, c].sum() == 0:
            i = int(rng.integers(0, n_nodes))
            labels[i, c] = True
            labeled[i] = True
    loc = sp.coo_matrix(labels.astype(np.float64))
    label_with_loc = np.flatnonzero(labels.sum(1) > 0).tolist()
    return loc, label_with_loc


def synthetic_dataset(
    n_nodes: int = 512,
    n_edges: int = 4096,
    seed: int = 70,
    feature_dims: Tuple[int, int, int] = (3, 250, 250),
):
    """Complete synthetic bundle: (ppi coo, feats, loc dense, label list)."""
    ppi = powerlaw_ppi(n_nodes, n_edges, seed)
    feats = synthetic_features(n_nodes, seed, *feature_dims)
    loc, label_list = synthetic_loc_matrix(n_nodes, seed)
    return ppi, feats, loc.toarray().astype(np.float32), label_list
