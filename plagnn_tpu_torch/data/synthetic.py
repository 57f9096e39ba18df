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
    # np.unique(np.stack([lo, hi], 1), axis=0), through one int64 key a
    # pair: the same pairs in the same order, several times faster
    key = np.unique(lo.astype(np.int64) * n_nodes + hi)
    pairs = np.stack([key // n_nodes, key % n_nodes], axis=1)
    if len(pairs) > m:
        pairs = pairs[rng.choice(len(pairs), size=m, replace=False)]
    row = np.concatenate([pairs[:, 0], pairs[:, 1]])
    col = np.concatenate([pairs[:, 1], pairs[:, 0]])
    data = np.ones(len(row), np.int8)
    return sp.coo_matrix((data, (row, col)), shape=(n_nodes, n_nodes))


def clustered_ppi(
    n_nodes: int,
    n_edges: int,
    seed: int = 70,
    mean_complex: float = 18.0,
    p_in: float = 0.55,
    frac_background: float = 0.25,
) -> sp.coo_matrix:
    """Community-structured symmetric adjacency: protein-complex near-cliques
    plus a power-law background.

    Real PPI networks are dominated by complexes — groups of proteins that
    interact almost all-to-all (the regime construct_uniprot_ppi ingests,
    data_preprocess.py:74-110) — so neighbor sets overlap heavily.  That
    overlap is what graph reordering (ops/reorder.py) exploits for DMA
    coalescing; the pure configuration model above has none by construction,
    so this generator is the honest measurement topology for that lever.

    Nodes are assigned to contiguous complexes of geometric-ish size; within
    a complex each pair is kept with probability ``p_in``;
    ``frac_background`` of the edge budget comes from powerlaw_ppi.  Node
    ids are SHUFFLED at the end so orderings must be *recovered* by the
    reordering pass rather than handed to it.
    """
    rng = np.random.default_rng(seed)
    m_target = n_edges // 2
    m_bg = int(m_target * frac_background)

    # complexes: contiguous id ranges (then shuffled)
    sizes = []
    total = 0
    while total < n_nodes:
        s = min(int(rng.geometric(1.0 / mean_complex)) + 2, n_nodes - total)
        sizes.append(s)
        total += s
    bounds = np.cumsum([0] + sizes)
    lo_l, hi_l = [], []
    m_in_budget = m_target - m_bg
    for c in range(len(sizes)):
        a0, a1 = bounds[c], bounds[c + 1]
        k = a1 - a0
        if k < 2:
            continue
        iu = np.triu_indices(k, 1)
        keep = rng.random(len(iu[0])) < p_in
        lo_l.append(iu[0][keep] + a0)
        hi_l.append(iu[1][keep] + a0)
    lo = np.concatenate(lo_l) if lo_l else np.empty(0, np.int64)
    hi = np.concatenate(hi_l) if hi_l else np.empty(0, np.int64)
    if len(lo) > m_in_budget:
        pick = rng.choice(len(lo), size=m_in_budget, replace=False)
        lo, hi = lo[pick], hi[pick]

    bg = powerlaw_ppi(n_nodes, 2 * m_bg, seed + 17)
    mask = bg.row < bg.col
    lo = np.concatenate([lo, bg.row[mask]])
    hi = np.concatenate([hi, bg.col[mask]])
    pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)

    # shuffle ids: the generator's contiguous layout must not leak
    shuf = rng.permutation(n_nodes)
    a = shuf[pairs[:, 0]]
    b = shuf[pairs[:, 1]]
    row = np.concatenate([a, b])
    col = np.concatenate([b, a])
    return sp.coo_matrix(
        (np.ones(len(row), np.int8), (row, col)), shape=(n_nodes, n_nodes))


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
