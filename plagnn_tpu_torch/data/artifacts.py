"""Artifact IO: loading the preprocessing products for training.

Port of ``plagnn_tpu/data/artifacts.py``: the load blocks of the reference's
main_normal.py / main_inter.py and the feature assembly
``feat = hstack(expr, gcn_pca, ecc_pca)`` -> (N, 503) float32,
``loc`` -> (N, 12) float32 dense, graph = PPI + self-loops.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from ..ops.graph_format import Graph, from_scipy_coo, pad_features


@dataclasses.dataclass
class DatasetBundle:
    graph: Graph             # on the host; the engine moves it to its device
    feats: np.ndarray        # (N_pad, F) float32
    labels: np.ndarray       # (N_pad, C) float32
    loc_mat: np.ndarray      # (N_real, C) dense (for class weights)
    label_with_loc: List[int]
    uniprot: List[str]
    n_real: int


def load_condition(data_root: str, dataset: str, condition: str) -> DatasetBundle:
    """Load one (dataset, condition in {'normal', 'inter'}) into a bundle."""
    gm = os.path.join(data_root, "generate_materials")
    ds_dir = os.path.join(gm, f"{dataset}_data")

    if condition == "normal":
        ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz"))
        ecc_pca = np.load(os.path.join(gm, "ECC_normal_pca.npy"))
        gcn_pca = np.load(os.path.join(ds_dir, "GCN_normal_pca.npy"))
        expr = np.load(os.path.join(ds_dir, "expr_normal.npy"))
    elif condition == "inter":
        ppi = sp.load_npz(os.path.join(ds_dir, "PPI_inter.npz")).tocoo()
        ecc_pca = np.load(os.path.join(ds_dir, "ECC_inter_pca.npy"))
        gcn_pca = np.load(os.path.join(ds_dir, "GCN_inter_pca.npy"))
        expr = np.load(os.path.join(ds_dir, "expr_inter.npy"))
    else:
        raise ValueError(condition)

    loc = sp.load_npz(os.path.join(gm, "loc_matrix.npz"))
    with open(os.path.join(gm, "protein_ppi.json")) as f:
        uniprot = json.load(f)
    with open(os.path.join(gm, "label_with_loc_list.json")) as f:
        label_with_loc = json.load(f)

    graph = from_scipy_coo(ppi, add_self_loops=True)
    feats = np.hstack([expr, np.hstack([gcn_pca, ecc_pca])]).astype(np.float32)
    loc_dense = loc.toarray().astype(np.float32)

    return DatasetBundle(
        graph=graph,
        feats=pad_features(feats, graph.n_nodes),
        labels=pad_features(loc_dense, graph.n_nodes),
        loc_mat=loc_dense,
        label_with_loc=label_with_loc,
        uniprot=uniprot,
        n_real=len(uniprot),
    )


def load_label_names(data_root: str) -> Optional[List[str]]:
    """Per-node uniprot accessions from label_list.json."""
    path = os.path.join(data_root, "generate_materials", "label_list.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        label_map = json.load(f)
    return [item[0] for item in label_map]
