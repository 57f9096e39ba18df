"""Preprocessing orchestrator (artifact materialization pipeline).

Port of ``plagnn_tpu/data/preprocess.py``, the reference's
``data_preprocess.py`` __main__ flow (:260-546), with the same artifact
contract under ``<root>/generate_materials``:

    PPI_normal.npz, protein_ppi.json, ECC_normal.npz, ECC_normal_pca.npy,
    loc_matrix.npz, label_list.json, label_with_loc_list.json,
    <GSE>_data/{GCN_normal.npz, GCN_inter.npz, expr_normal.npy,
                expr_inter.npy, PPI_inter.npz, ECC_inter.npz,
                GCN_normal_pca.npy, GCN_inter_pca.npy, ECC_inter_pca.npy}

the same steps in the same order and the same skip-if-exists caching.
The JAX package's host work stays host numpy here (the parsers, the dense
PCC of the ``GCN_*.npz`` artifacts); three steps run on ``device``: the
ECC triangle counts (``ops/common_neighbors.py``), the perturbation
topology (``data/topology.py``, the ΔPCC hit scan) and the PCAs
(``data/pca.py``, whose dense inputs are built there from the sparse
matrices).  Without pandas or sklearn.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from .biogrid import construct_normal_ppi
from .ecc import edge_clustering_coefficients
from .expression import align_expression, pcc_at_edges, pcc_dense, pcc_factors
from .pca import pca
from .topology import modify_network_topology
from .uniprot import construct_loc_matrix


@dataclasses.dataclass
class DatasetConfig:
    """One GSE dataset (mirrors the data_dict entries,
    data_preprocess.py:491-523)."""
    name: str
    expr_csv: str
    normal_samples: Tuple[str, str, str]
    intervention_samples: Tuple[str, str, str]
    threshold: float


DEFAULT_DATASETS = (
    DatasetConfig(
        "GSE30931", "support_materials/GSE30931_exprSet.csv",
        ("GSM766676", "GSM766677", "GSM766678"),
        ("GSM766682", "GSM766683", "GSM766684"), 2.75,
    ),
    DatasetConfig(
        "GSE27182", "support_materials/GSE27182_exprSet.csv",
        ("GSM671731", "GSM671732", "GSM671733"),
        ("GSM671725", "GSM671726", "GSM671727"), 2.99,
    ),
    DatasetConfig(
        "GSE74572", "support_materials/GSE74572_exprSet.csv",
        ("GSM1923199", "GSM1923200", "GSM1923201"),
        ("GSM1923205", "GSM1923206", "GSM1923207"), 2.91,
    ),
)


def _exists(path):
    return os.path.exists(path)


def preprocess(
    data_root: str,
    datasets: Sequence[DatasetConfig] = DEFAULT_DATASETS,
    *,
    mitab_file: str = "support_materials/BIOGRID-ORGANISM-Homo_sapiens-4.4.203.mitab.txt",
    uniprot_file: str = "support_materials/uniprot_sprot_human.dat.gz",
    cellular_component_file: str = "support_materials/cellular_component.txt",
    pca_components: int = 250,
    dense_gcn_artifacts: bool = True,
    verbose: bool = True,
    device="cuda",
) -> List[Tuple[str, float]]:
    """Run the full artifact pipeline rooted at ``data_root`` with
    skip-if-exists caching (the reference's resume mechanism).  Returns the
    (step, wall seconds) of each step that ran."""
    gm = os.path.join(data_root, "generate_materials")
    os.makedirs(gm, exist_ok=True)
    log = print if verbose else (lambda *a, **k: None)
    steps: List[Tuple[str, float]] = []

    def step(name, t0):
        dt = time.perf_counter() - t0
        steps.append((name, dt))
        log(f"  {name}: {dt:.3f} s")

    def p(*parts):
        return os.path.join(data_root, *parts)

    # --- PPI + protein list (:270-286) ------------------------------------
    ppi_path = os.path.join(gm, "PPI_normal.npz")
    plist_path = os.path.join(gm, "protein_ppi.json")
    if not _exists(ppi_path):
        log("building PPI from mitab ...")
        t0 = time.perf_counter()
        ppi_normal, protein_list = construct_normal_ppi(p(mitab_file))
        sp.save_npz(ppi_path[:-4], ppi_normal)
        if not _exists(plist_path):
            with open(plist_path, "w") as f:
                json.dump(protein_list, f)
        step("PPI", t0)
    else:
        ppi_normal = sp.load_npz(ppi_path)
        with open(plist_path) as f:
            protein_list = json.load(f)
    log(f"PPI: {ppi_normal.shape[0]} proteins, {ppi_normal.nnz} directed edges")

    # --- ECC normal (:288-292) --------------------------------------------
    ecc_path = os.path.join(gm, "ECC_normal.npz")
    if not _exists(ecc_path):
        log(f"computing ECC (common-neighbour counts on {device}) ...")
        t0 = time.perf_counter()
        sp.save_npz(ecc_path[:-4], edge_clustering_coefficients(ppi_normal, device=device))
        step("ECC normal", t0)

    # --- per-GSE condition matrices (:294-330) ----------------------------
    for ds in datasets:
        inter_dir = os.path.join(gm, f"{ds.name}_data")
        os.makedirs(inter_dir, exist_ok=True)
        csv_path = p(ds.expr_csv)

        t0 = time.perf_counter()
        expr_normal = align_expression(csv_path, ds.normal_samples, protein_list)
        expr_inter = align_expression(csv_path, ds.intervention_samples, protein_list)

        if not _exists(os.path.join(inter_dir, "expr_normal.npy")):
            np.save(os.path.join(inter_dir, "expr_normal"), expr_normal)
        if not _exists(os.path.join(inter_dir, "expr_inter.npy")):
            np.save(os.path.join(inter_dir, "expr_inter"), expr_inter)
        step(f"{ds.name} expression", t0)
        if dense_gcn_artifacts:
            if not _exists(os.path.join(inter_dir, "GCN_normal.npz")):
                log(f"{ds.name}: dense PCC (normal) ...")
                sp.save_npz(os.path.join(inter_dir, "GCN_normal"),
                            sp.coo_matrix(pcc_dense(expr_normal)))
            if not _exists(os.path.join(inter_dir, "GCN_inter.npz")):
                log(f"{ds.name}: dense PCC (inter) ...")
                sp.save_npz(os.path.join(inter_dir, "GCN_inter"),
                            sp.coo_matrix(pcc_dense(expr_inter)))

        if not _exists(os.path.join(inter_dir, "PPI_inter.npz")):
            log(f"{ds.name}: topology adjustment (thr={ds.threshold}) ...")
            t0 = time.perf_counter()
            ppi_inter = modify_network_topology(
                ppi_normal, pcc_factors(expr_normal), pcc_factors(expr_inter),
                ds.threshold, device=device,
            )
            sp.save_npz(os.path.join(inter_dir, "PPI_inter"), ppi_inter)
            step(f"{ds.name} topology", t0)
        else:
            ppi_inter = sp.load_npz(os.path.join(inter_dir, "PPI_inter.npz"))

        if not _exists(os.path.join(inter_dir, "ECC_inter.npz")):
            log(f"{ds.name}: ECC (inter) ...")
            t0 = time.perf_counter()
            sp.save_npz(os.path.join(inter_dir, "ECC_inter"),
                        edge_clustering_coefficients(ppi_inter, device=device))
            step(f"{ds.name} ECC inter", t0)

    # --- localization labels (:438-454) -----------------------------------
    if not _exists(os.path.join(gm, "loc_matrix.npz")):
        log("extracting localization annotations ...")
        t0 = time.perf_counter()
        construct_loc_matrix(
            p(uniprot_file), p(cellular_component_file), protein_list, gm
        )
        step("labels", t0)

    # --- PCA features (:528-546) ------------------------------------------
    def save_pca(path, name, mat):
        t0 = time.perf_counter()
        np.save(path, pca(mat, pca_components, device=device))
        step(f"PCA {name}", t0)

    if not _exists(os.path.join(gm, "ECC_normal_pca.npy")):
        log("PCA: ECC normal ...")
        save_pca(os.path.join(gm, "ECC_normal_pca"), "ECC normal", sp.load_npz(ecc_path))

    ppi_csr = ppi_normal.tocsr()

    def masked_gcn(inter_dir: str, cond: str, ppi_mask) -> sp.spmatrix:
        """PPI-masked PCC for the PCA stage.  Uses the dense GCN artifact
        when present; in lean mode (--no-dense-gcn) reconstructs it from the
        expression factors at edge positions only -- the PCA input is
        ``gcn.multiply(ppi)`` (data_preprocess.py:535-540), E-sparse, so the
        dense full-PCC artifact is never actually needed."""
        npz = os.path.join(inter_dir, f"GCN_{cond}.npz")
        if _exists(npz):
            return sp.load_npz(npz).tocsr().multiply(ppi_mask)
        z = pcc_factors(np.load(os.path.join(inter_dir, f"expr_{cond}.npy")))
        coo = ppi_mask.tocoo()
        vals = pcc_at_edges(z, coo.row, coo.col)
        return sp.coo_matrix((vals, (coo.row, coo.col)), shape=ppi_mask.shape)

    for ds in datasets:
        inter_dir = os.path.join(gm, f"{ds.name}_data")
        if not _exists(os.path.join(inter_dir, "GCN_normal_pca.npy")):
            log(f"{ds.name}: PCA GCN normal ...")
            save_pca(os.path.join(inter_dir, "GCN_normal_pca"), f"{ds.name} GCN normal",
                     masked_gcn(inter_dir, "normal", ppi_csr))
        if not _exists(os.path.join(inter_dir, "GCN_inter_pca.npy")):
            log(f"{ds.name}: PCA GCN inter ...")
            ppi_i = sp.load_npz(os.path.join(inter_dir, "PPI_inter.npz")).tocsr()
            save_pca(os.path.join(inter_dir, "GCN_inter_pca"), f"{ds.name} GCN inter",
                     masked_gcn(inter_dir, "inter", ppi_i))
        if not _exists(os.path.join(inter_dir, "ECC_inter_pca.npy")):
            log(f"{ds.name}: PCA ECC inter ...")
            save_pca(os.path.join(inter_dir, "ECC_inter_pca"), f"{ds.name} ECC inter",
                     sp.load_npz(os.path.join(inter_dir, "ECC_inter.npz")))
    log("preprocessing complete")
    return steps
