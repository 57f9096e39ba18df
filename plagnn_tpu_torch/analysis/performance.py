"""CV performance evaluation + random-guess baselines.

Port of ``plagnn_tpu/analysis/performance.py`` (the reference's
performance.py): merge per-round fold logits (mean of 10 folds), threshold
at alpha = 0.1, report AIM/COV/mlACC mean +- std over 10 rounds restricted
to annotated proteins, plus two random null models (matched-count and
uniform-count), F1 and AUC.  Host numpy, with no device work.

sklearn is not used: ``roc_auc`` is the Mann-Whitney rank AUC in float64
(``scipy.stats.rankdata``, average ranks for ties), which equals
``sklearn.metrics.roc_auc_score`` up to rounding.  Where the labels hold
one class only it warns and returns nan, as the sklearn installed beside
the JAX package (1.9.0) does, with sklearn's message and a warning class
of the same name (``UndefinedMetricWarning``), so ``performance`` reports
nan wherever the JAX package does.
"""
from __future__ import annotations

import glob
import json
import os
import random
import warnings
from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as sp
from scipy.stats import rankdata

from ..train.metrics import macro_f1_np, micro_f1_np
from ..train.postprocess import protein_loc_correction_np


class UndefinedMetricWarning(UserWarning):
    """The metric is not defined on these labels (sklearn's class name)."""


def roc_auc(y_true, y_score) -> float:
    """Binary ROC AUC as the normalized Mann-Whitney U statistic:
    (sum of the positives' average ranks - P(P+1)/2) / (P·N), in float64.
    The larger of the two label values is the positive class; labels of
    one class give nan and an ``UndefinedMetricWarning``."""
    y = np.asarray(y_true).reshape(-1)
    s = np.asarray(y_score, np.float64).reshape(-1)
    classes = np.unique(y)
    if len(classes) < 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not "
                      "defined in that case.", UndefinedMetricWarning)
        return float("nan")
    if len(classes) > 2:
        raise ValueError(f"y_true must be binary, got {len(classes)} classes")
    pos = y == classes[1]
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    ranks = rankdata(s, method="average")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def performances_record(loc_true: np.ndarray, loc_pred: np.ndarray) -> List[float]:
    """AIM/COV/mlACC (the reference's performance.py:59-90), without its
    in-place mutation of the inputs (:73-74)."""
    t = np.asarray(loc_true) > 0.5
    p = np.asarray(loc_pred) > 0.5
    and_set = (t & p).sum(1)
    pred = p.sum(1)
    real = t.sum(1)
    or_set = (t | p).sum(1)
    aim = float(np.where(pred > 0, and_set / np.maximum(pred, 1), 0.0).mean())
    cov = float((and_set / np.maximum(real, 1)).mean())
    acc = float(np.where(or_set > 0, and_set / np.maximum(or_set, 1), 0.0).mean())
    return [aim, cov, acc]


def random_pred(pred: np.ndarray, setnum: bool = True, seed=None) -> np.ndarray:
    """Random-guess matrices (the reference's performance.py:36-56); the
    same ``random.Random(seed)`` draws as the JAX package."""
    rng = random.Random(seed)
    random_mat = np.zeros(pred.shape)
    n_classes = pred.shape[1]
    if setnum:
        pt_num = pred.sum(axis=1).astype(int)
        for idx in range(len(pt_num)):
            rloc = rng.sample(range(n_classes), min(pt_num[idx], n_classes))
            random_mat[idx, rloc] = 1
    else:
        for idx in range(len(random_mat)):
            pt_num = rng.randint(0, n_classes)
            rloc = rng.sample(range(n_classes), pt_num)
            random_mat[idx, rloc] = 1
    return random_mat


def mat_merge(log_root: str, n_nodes: int, n_classes: int = 12,
              rounds: int = 10, fold_num: int = 10) -> None:
    """Per-round mean of fold logits -> {state}_{round}_logits.npy (the
    reference's performance.py:93-106)."""
    for paths in sorted(glob.glob(os.path.join(log_root, "GSE*"))):
        for state in ("normal", "perturbation"):
            log_path = os.path.join(paths, state)
            if not os.path.isdir(log_path):
                continue
            for num in range(1, rounds + 1):
                files = sorted(
                    glob.glob(os.path.join(log_path, f"{num}_*_loc_logits.npy"))
                )
                if not files:
                    continue
                mat_cnt = np.zeros((n_nodes, n_classes))
                for f in files:
                    mat_cnt += np.load(f)
                if len(files) != fold_num:
                    # Parity keeps the fixed ÷fold_num (performance.py:104);
                    # warn so a partial run can't mis-scale silently.
                    warnings.warn(
                        f"mat_merge: round {num} in {log_path} has "
                        f"{len(files)} fold dumps but divides by {fold_num} "
                        f"(reference-parity fixed denominator)")
                mat_cnt /= fold_num
                np.save(
                    os.path.join(log_path, f"{state}_{num}_logits.npy"), mat_cnt
                )


def performance(
    data_root: str,
    rounds: int = 10,
    alpha: float = 0.1,
    states: Sequence[str] = ("normal",),
    verbose: bool = True,
    compute_auc: bool = True,
) -> Dict[str, Dict[str, float]]:
    """Aggregate CV metrics (the reference's performance.py:109-162).  Returns
    {dataset/state: {metric: value}} and prints the reference's report."""
    gm = os.path.join(data_root, "generate_materials")
    with open(os.path.join(gm, "label_with_loc_list.json")) as f:
        label = json.load(f)
    true_mat = sp.load_npz(os.path.join(gm, "loc_matrix.npz")).toarray()[label]
    log_root = os.path.join(data_root, "log")

    results: Dict[str, Dict[str, float]] = {}
    out = print if verbose else (lambda *a, **k: None)
    for paths in sorted(glob.glob(os.path.join(log_root, "GSE*"))):
        for state in states:
            out(paths)
            aims, covs, accs, auc_mi, auc_ma = [], [], [], [], []
            f1_mi, f1_ma = [], []
            for num in range(1, rounds + 1):
                path = os.path.join(paths, state, f"{state}_{num}_logits.npy")
                if not os.path.exists(path):
                    continue
                logit = np.load(path)
                pred = protein_loc_correction_np(logit, alpha)[label]
                a, c, m = performances_record(true_mat, pred)
                aims.append(a)
                covs.append(c)
                accs.append(m)
                # F1: the numpy twins of the train-time metrics
                f1_mi.append(micro_f1_np(true_mat, pred))
                f1_ma.append(macro_f1_np(true_mat, pred))
                if compute_auc:
                    scores = logit[label]
                    auc_mi.append(roc_auc(
                        true_mat.reshape(-1), scores.reshape(-1)))
                    per = []
                    for j in range(true_mat.shape[1]):
                        col = true_mat[:, j]
                        per.append(
                            0.5 if col.min() == col.max()
                            else roc_auc(col, scores[:, j])
                        )
                    auc_ma.append(float(np.mean(per)))
            if not aims:
                continue
            key = f"{os.path.basename(paths)}/{state}"
            results[key] = {
                "AIM": float(np.mean(aims)), "AIM_std": float(np.std(aims)),
                "COV": float(np.mean(covs)), "COV_std": float(np.std(covs)),
                "mlACC": float(np.mean(accs)), "mlACC_std": float(np.std(accs)),
            }
            if compute_auc and auc_mi:
                results[key]["AUC_micro"] = float(np.mean(auc_mi))
                results[key]["AUC_macro"] = float(np.mean(auc_ma))
            results[key]["F1_micro"] = float(np.mean(f1_mi))
            results[key]["F1_macro"] = float(np.mean(f1_ma))
            out("AIM: {:.3f} +- {:.3f}".format(results[key]["AIM"], results[key]["AIM_std"]))
            out("COV: {:.3f} +- {:.3f}".format(results[key]["COV"], results[key]["COV_std"]))
            out("mlACC: {:.3f} +- {:.3f}".format(results[key]["mlACC"], results[key]["mlACC_std"]))
            if compute_auc and auc_mi:
                out("AUC(micro): {:.3f}  AUC(macro): {:.3f}".format(
                    results[key]["AUC_micro"], results[key]["AUC_macro"]))
            out("F1(micro): {:.3f}  F1(macro): {:.3f}".format(
                results[key]["F1_micro"], results[key]["F1_macro"]))

    # Random baselines (performance.py:138-161).  The reference seeds the
    # matched-count null from a merged logits matrix (row sums of the raw
    # probabilities, truncated to int, :138-144); use one when available.
    fmt_candidates = sorted(glob.glob(
        os.path.join(log_root, "GSE*", "*", "*_1_logits.npy")))
    fmt = np.load(fmt_candidates[0]) if fmt_candidates else true_mat
    shape_like = np.zeros_like(true_mat)
    r_t, r_f = [], []
    for i in range(10):
        r_t.append(performances_record(
            true_mat, random_pred(fmt, True, seed=i)[: len(true_mat)]))
        r_f.append(performances_record(true_mat, random_pred(shape_like, False, seed=i)))
    r_t, r_f = np.array(r_t), np.array(r_f)
    results["random_limit"] = {
        "AIM": float(r_t[:, 0].mean()), "COV": float(r_t[:, 1].mean()),
        "mlACC": float(r_t[:, 2].mean()),
    }
    results["random"] = {
        "AIM": float(r_f[:, 0].mean()), "COV": float(r_f[:, 1].mean()),
        "mlACC": float(r_f[:, 2].mean()),
    }
    out("Random limit")
    out("AIM: {:.3f} +- {:.3f}".format(r_t[:, 0].mean(), r_t[:, 0].std()))
    out("COV: {:.3f} +- {:.3f}".format(r_t[:, 1].mean(), r_t[:, 1].std()))
    out("mlACC: {:.3f} +- {:.3f}".format(r_t[:, 2].mean(), r_t[:, 2].std()))
    out("Random")
    out("AIM: {:.3f} +- {:.3f}".format(r_f[:, 0].mean(), r_f[:, 0].std()))
    out("COV: {:.3f} +- {:.3f}".format(r_f[:, 1].mean(), r_f[:, 1].std()))
    out("mlACC: {:.3f} +- {:.3f}".format(r_f[:, 2].mean(), r_f[:, 2].std()))
    return results
