"""The figures' data.

Port of ``plagnn_tpu/analysis/figures.py`` without its drawing: the port's
machines have no matplotlib, so ``plot_diff_histogram``, ``fig_alpha`` and
``fig_and_perf`` write, in place of each PNG, the data the plot is drawn
from as JSON under the same stem (``diff_hist.json``, ``alpha_dist.json``,
``AIM.json``/``COV.json``/``mlACC.json``; floats as Python's repr, so they
round-trip exactly).

* ``diff_histogram``: ΔPCC counts of linked and unlinked pairs over all N²
  pairs, the diagonal excluded, through the histogram entry of the ΔPCC
  scan (``ops/pcc_scan.py: pcc_diff_histogram``, the CUDA kernel on a
  card).  The JAX package computes d with numpy GEMM blocks, which round
  differently from the scan's fixed order, so a pair whose d lies within
  ~1e-15 of a bin edge may fall in the neighbouring bin there.
* ``save_diff`` / ``hist_data_from_diff``: host numpy, copied, so the
  ``diff*.npy`` and ``hist_data.json`` files are byte-identical to the JAX
  package's on the same machine.
* ``subcellular_fig_data``, ``organelle_distribution``,
  ``final_pred_counts``, ``fig_alpha_data_from_txt``: host, copied.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Sequence

import numpy as np
import scipy.sparse as sp
import torch
from scipy.spatial.distance import jensenshannon

from ..ops.pcc_scan import csr_tensors, pcc_diff_histogram


def default_bins() -> np.ndarray:
    """The reference's 201 ΔPCC bin edges, ``np.arange(-2, 2 + 1e-9,
    0.02)``: the last is not exactly 2.0 and the middle one is 1.78e-15,
    not 0; the bins come from comparisons with these values."""
    return np.arange(-2.0, 2.0 + 1e-9, 0.02)


def positive_csr(ppi, device):
    """(indptr, indices) of the PPI's entries with a value > 0 (duplicates
    summed first): the pairs the JAX package's mask ``ppi > 0`` marks."""
    m = ppi.tocsr(copy=True)
    m.sum_duplicates()
    m.data = (m.data > 0).astype(np.int8)
    return csr_tensors(m, device)


def diff_histogram(z_inter, z_nor, ppi, bins=None, *, device):
    """(bins, linked, unlinked): int64 counts of ΔPCC = z_inter·z_interᵀ -
    z_nor·z_norᵀ in each bin (np.histogram's rule for an array of edges)
    over the pairs i != j, linked where ``ppi`` has a value > 0, from the
    (N, k) float64 factors, scanned on ``device``."""
    if bins is None:
        bins = default_bins()
    dev = torch.device(device)
    z_i = torch.as_tensor(np.ascontiguousarray(z_inter, np.float64), device=dev)
    z_n = torch.as_tensor(np.ascontiguousarray(z_nor, np.float64), device=dev)
    edges = torch.as_tensor(np.asarray(bins, np.float64), device=dev)
    linked, unlinked = pcc_diff_histogram(z_i, z_n, edges, positive_csr(ppi, dev))
    return bins, linked.cpu().numpy(), unlinked.cpu().numpy()


def save_diff(z_inter, z_nor, ppi, out_dir: str, block_rows: int = 2048):
    """Persist the ΔPCC artifact triple ``diff.npy`` / ``diff_link.npy`` /
    ``diff_unlink.npy`` (the reference's figure.py:10-33 contract) from
    factor matrices: ``diff_link = diff[ppi > 0]``, ``diff_unlink`` the rest,
    the diagonal included as 0, ``diff.npy`` the row-major flatten.  The
    saved arrays are O(N²)."""
    n = z_inter.shape[0]
    ppi = ppi.tocsr()
    all_parts, link_parts, unlink_parts = [], [], []
    for r0 in range(0, n, block_rows):
        r1 = min(r0 + block_rows, n)
        d = z_inter[r0:r1] @ z_inter.T - z_nor[r0:r1] @ z_nor.T
        # the artifacts carry zero diagonals; the factor form's
        # self-correlation is 1, so the artifact value is forced
        rr = np.arange(r0, r1)
        d[rr - r0, rr] = 0.0
        mask = np.asarray(ppi[r0:r1].todense()) > 0
        all_parts.append(d.ravel())
        link_parts.append(d[mask])
        unlink_parts.append(d[~mask])
    np.save(os.path.join(out_dir, "diff.npy"), np.concatenate(all_parts))
    np.save(os.path.join(out_dir, "diff_link.npy"), np.concatenate(link_parts))
    np.save(os.path.join(out_dir, "diff_unlink.npy"),
            np.concatenate(unlink_parts))


def hist_data_from_diff(gse_dir: str) -> dict:
    """Rebuild ``hist_data.json`` from the saved diff artifacts (the
    reference's get_fig_data, figure.py:36-76): 201 bin edges at -2 +
    0.02·i, counts as ``[[i, count], ...]``, binned by
    ``floor((d + 2) / 0.02)``."""
    hist_data = {}
    pcc_bin = [-2 + 0.02 * i for i in range(0, 201)]
    for fname, flag in (("diff.npy", "all"), ("diff_link.npy", "link"),
                        ("diff_unlink.npy", "unlink")):
        mat = np.load(os.path.join(gse_dir, fname)).flatten()
        idx = ((mat - (-2)) / 0.02).astype(np.int64)
        counts = np.bincount(idx, minlength=201)[:201]
        hist_data[flag] = [pcc_bin, [[i, int(c)] for i, c in enumerate(counts)]]
    out = os.path.join(gse_dir, "hist_data.json")
    with open(out, "w") as f:
        json.dump(hist_data, f)
    return hist_data


def write_json(path: str, data) -> str:
    """``data`` as JSON (floats as their repr); returns the path."""
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def diff_hist_json(path: str, bins, linked, unlinked) -> str:
    """What ``plot_diff_histogram`` draws: the edges and both count
    vectors."""
    return write_json(path, {"bins": [float(b) for b in bins],
                             "linked": [int(c) for c in linked],
                             "unlinked": [int(c) for c in unlinked]})


def subcellular_fig_data(loc_matrix_path: str) -> Dict[int, int]:
    """#annotations-per-protein counts (figure.py:109-123)."""
    loc = sp.load_npz(loc_matrix_path).toarray()
    counts = loc.sum(1).astype(int)
    return {k: int((counts == k).sum()) for k in range(0, counts.max() + 1)}


def organelle_distribution(pred: np.ndarray) -> np.ndarray:
    """Per-organelle share of predicted localizations."""
    num = pred.sum(0).astype(np.float64)
    return num / max(num.sum(), 1.0)


def _scrape_final_counts(lines: Sequence[str]) -> list:
    """The reference scraper's core (figure.py:147-171): from a txt_log.txt
    body (header stripped), collect each fold block's final per-organelle
    prediction-count table row: the line right before every '-----'/'-----'
    double separator, plus the file's last line."""
    per_data = []
    for i in range(len(lines)):
        if i > (len(lines) - 3):
            d = lines[-1].strip().split(")")[0:-1]
            per_data.append(
                [p.split("%")[-1].strip().split("(")[-1] for p in d])
            break
        first, second, third = lines[i], lines[i + 1], lines[i + 2]
        if "-----" in second and "------" in third:
            d = first.strip().split(")")[0:-1]
            per_data.append(
                [p.split("%")[-1].strip().split("(")[-1] for p in d])
    return per_data


def final_pred_counts(log_dir: str, alpha: str) -> np.ndarray:
    """Per-(round, fold) final-epoch per-organelle prediction counts for one
    alpha (what the reference's fig_alpha_data averages, figure.py:126-177),
    from the ``pred_num_final`` channel of fig_data_{round}.json, or scraped
    from txt_log.txt for runs without it.  Returns (n_runs, 12) float."""
    counts = []
    for fd in sorted(glob.glob(os.path.join(log_dir, "fig_data_*.json"))):
        with open(fd) as f:
            data = json.load(f)
        folds = data.get("validation", {}).get(str(alpha), {})
        for curves in folds.values():
            if "pred_num_final" in curves:
                counts.append(curves["pred_num_final"])
    if not counts:
        txt = os.path.join(log_dir, "txt_log.txt")
        if os.path.exists(txt):
            with open(txt) as f:
                lines = f.readlines()[3:]
            counts = _scrape_final_counts(lines)
    if not counts:
        return np.zeros((0, 12))
    return np.asarray(counts, np.float64)


def fig_alpha(log_dir: str, out_path: str, label_dist: np.ndarray,
              alphas: Sequence[str] = ("0.1",)):
    """What the JAX ``fig_alpha`` draws (figure.py:179-235), as JSON at
    ``out_path``: the annotation distribution ``label_dist`` and, per alpha,
    the mean over all (round, fold) runs of the final-epoch prediction
    counts truncated to int (figure.py:210), that normalized to a
    distribution, and its Jensen-Shannon distance to ``label_dist``.
    Alphas without runs are left out.  Returns {alpha: JS distance}, or
    None without runs, as the JAX function does."""
    data = {"label_dist": [float(v) for v in label_dist], "alphas": {}}
    for alpha in alphas:
        per = final_pred_counts(log_dir, alpha)
        if per.size == 0:
            continue
        d_data = np.array([int(v) for v in per.mean(axis=0)], np.float64)
        dist = d_data / max(d_data.sum(), 1.0)
        data["alphas"][str(alpha)] = {
            "counts": [int(v) for v in d_data],
            "dist": [float(v) for v in dist],
            "js": float(jensenshannon(label_dist, dist)),
        }
    write_json(out_path, data)
    js = {a: v["js"] for a, v in data["alphas"].items()}
    return js if js else None


def fig_and_perf(fig_data_path: str, out_dir: str | None = None):
    """Metric-vs-epoch curves averaged over folds (utils.py:54-89); with
    ``out_dir``, each metric's curves by alpha as ``{metric}.json`` there."""
    with open(fig_data_path) as f:
        fig_data = json.load(f)
    val_data = fig_data["validation"]
    first_alpha = next(iter(val_data))
    length = len(val_data[first_alpha]["1"]["aim"])
    f_num = len(val_data[first_alpha])
    f_data = {"AIM": {}, "COV": {}, "mlACC": {}}
    key_of = {"AIM": "aim", "COV": "cov", "mlACC": "acc"}
    for alpha in val_data:
        for label, k in key_of.items():
            acc = np.zeros(length)
            for fold in val_data[alpha].values():
                acc += np.array(fold[k])
            f_data[label][alpha] = acc / f_num
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        for item, curves in f_data.items():
            write_json(os.path.join(out_dir, f"{item}.json"),
                       {alpha: c.tolist() for alpha, c in curves.items()})
    return f_data


def fig_alpha_data_from_txt(log_root: str):
    """The reference's txt-log scraper (figure.py:126-177): the final
    per-organelle prediction-count table of each fold run, from
    ``GSE*/normal/txt_log.txt``, averaged per dataset."""
    dicts = {}
    for paths in sorted(glob.glob(os.path.join(log_root, "GSE*"))):
        file_path = os.path.join(paths, "normal", "txt_log.txt")
        if not os.path.exists(file_path):
            continue
        with open(file_path) as f:
            content = f.readlines()
        per_data = _scrape_final_counts(content[3:])
        if per_data:
            arr = np.array(per_data).astype(float)
            dicts[os.path.basename(paths)] = arr.mean(axis=0).tolist()
    return dicts
