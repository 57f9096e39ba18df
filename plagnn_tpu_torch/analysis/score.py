"""Mis-localization scoring, the paper's end product.

Port of ``plagnn_tpu/analysis/score.py`` (the reference's main.py): merge
the 100 per-fold logit files per (dataset, state) with the
column-min-max/row-sum scaler (/100), then rank all (protein, organelle)
entries of ``diff = (inter - normal) / normal`` descending and write
loc_change_record.csv + res_alldata.json (skipping ``diff == -1.0``
entries, the reference's division-by-zero guard, main.py:150).

Host numpy, as in the JAX package: the same float64 values and the same
``np.argsort(...)[::-1]`` give the same ranking and tie order, so both
files are byte-identical to the JAX package's.  No device work.
"""
from __future__ import annotations

import csv
import glob
import json
import os
import warnings
from typing import Dict, Sequence

import numpy as np

from ..train.postprocess import scaling_np

LOC_MAP = {
    "GO:0005938": "Cell cortex",
    "GO:0005829": "Cytosol",
    "GO:0015629": "Actin cytoskeleton",
    "GO:0005794": "Golgi apparatus",
    "GO:0005783": "Endoplasmic reticulum",
    "GO:0005730": "Nucleolus",
    "GO:0005777": "Peroxisome",
    "GO:0005739": "Mitochondrion",
    "GO:0005764": "Lysosome",
    "GO:0005813": "Centrosome",
    "GO:0005634": "Nucleus",
    "GO:0005886": "Plasma membrane",
}

STATES = ("normal", "perturbation")


def mat_merge(log_root: str, res_root: str, n_nodes: int, n_classes: int = 12,
              denom: float = 100.0) -> None:
    """Scale-and-average every per-fold logit dump per state
    (main.py:32-48; the ÷100 matches 10 rounds × 10 folds)."""
    for paths in sorted(glob.glob(os.path.join(log_root, "GSE*"))):
        for state in STATES:
            state_dir = os.path.join(paths, state)
            res_dir = os.path.join(res_root, os.path.basename(paths))
            os.makedirs(res_dir, exist_ok=True)
            mat_cnt = np.zeros((n_nodes, n_classes))
            files = sorted(glob.glob(os.path.join(state_dir, "*_loc_logits.npy")))
            for f in files:
                mat_cnt += scaling_np(np.load(f))
            if files and len(files) != int(denom):
                # Reference parity keeps the FIXED denominator (main.py:47
                # divides by 100 no matter how many dumps exist), but a
                # partial run silently mis-scales the merge — warn loudly.
                warnings.warn(
                    f"mat_merge: {state_dir} has {len(files)} logit dumps but "
                    f"divides by {denom:g} (reference-parity fixed "
                    f"denominator); merged logits are scaled by "
                    f"{len(files) / denom:.2f} of a full run")
            mat_cnt /= denom
            np.save(os.path.join(res_dir, f"{state}_logits.npy"), mat_cnt)


def misloc_protein_record(
    normal_mat: np.ndarray,
    inter_mat: np.ndarray,
    out_dir: str,
    protein_list: Sequence[str],
    loc_list: Sequence[str],
) -> Dict:
    """Ranked mis-localization table (main.py:51-175, 'all data' branch)."""
    normal = scaling_np(normal_mat)
    inter = scaling_np(inter_mat)
    with np.errstate(divide="ignore", invalid="ignore"):
        diff_matrix = (inter - normal) / normal
    order = np.argsort(diff_matrix.reshape(-1))[::-1]

    os.makedirs(out_dir, exist_ok=True)
    res_alldata: Dict[str, list] = {}
    rank = 1
    n_loc = len(loc_list)
    with open(os.path.join(out_dir, "loc_change_record.csv"), "a") as f:
        writer = csv.writer(f, delimiter=",")
        writer.writerow(
            ["Protein", "Score", "Altered localization", "Normal score",
             "Perturbation score"]
        )
        for indice in order:
            row, col = int(indice) // n_loc, int(indice) % n_loc
            score = diff_matrix[row][col]
            if score == -1.0:
                continue
            # reference records only strictly gained (>0) or lost (<0)
            # locations (main.py:155-172); NaN/0 entries fall through both
            if not (score > 0 or score < 0):
                continue
            location = LOC_MAP[loc_list[col]]
            normal_score = normal[row][col]
            inter_score = inter[row][col]
            protein = protein_list[row]
            writer.writerow([protein, score, location, normal_score, inter_score])
            entry = [float(score), location, rank, float(normal_score),
                     float(inter_score)]
            res_alldata.setdefault(protein, []).append(entry)
            rank += 1

    with open(os.path.join(out_dir, "res_alldata.json"), "w") as f:
        json.dump(res_alldata, f)
    return res_alldata


def score_all(
    data_root: str,
    datasets: Sequence[str] = ("GSE27182", "GSE30931", "GSE74572"),
    n_nodes: int | None = None,
) -> None:
    """Full main.py flow: merge then rank, per dataset (main.py:178-183)."""
    gm = os.path.join(data_root, "generate_materials")
    with open(os.path.join(data_root, "support_materials",
                           "cellular_component.txt")) as f:
        loc_list = f.read().split()
    with open(os.path.join(gm, "protein_ppi.json")) as f:
        protein_list = json.load(f)
    if n_nodes is None:
        n_nodes = len(protein_list)

    log_root = os.path.join(data_root, "log")
    res_root = os.path.join(data_root, "res")
    mat_merge(log_root, res_root, n_nodes)
    for ds in datasets:
        res_dir = os.path.join(res_root, ds)
        n_path = os.path.join(res_dir, "normal_logits.npy")
        i_path = os.path.join(res_dir, "perturbation_logits.npy")
        if not (os.path.exists(n_path) and os.path.exists(i_path)):
            # the reference (main.py:180) hard-fails here when a dataset
            # was not trained; skip it instead
            print(f"[score] {ds}: merged logits missing, skipping")
            continue
        misloc_protein_record(
            np.load(n_path), np.load(i_path), res_dir, protein_list, loc_list
        )
