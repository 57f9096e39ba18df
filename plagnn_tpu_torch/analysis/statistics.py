"""Topology-adjustment statistics + co-localization audits.

Port of ``plagnn_tpu/analysis/statistics.py`` (the reference's
statistics.py): per dataset, recompute the diff thresholds, count
removed/added/below/above-threshold entries, and run the co-localization
consistency analysis of added/removed/normal edges, appending to
``log/statistics.txt`` in the reference's line formats.

The dense N² count of ``threshold_counts`` runs on the device, through the
ΔPCC count scan (``ops/pcc_scan.py``, the CUDA kernel
``csrc/pcc_diff_scan.cu`` on a card), from factors and thresholds computed
in float64 on the device; the removed/added edge algebra stays scipy on the
host.  The report's numbers are integers and ratios of integers, so the
file is byte-identical to the JAX package's.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from ..data.expression import pcc_factors_torch
from ..data.topology import diff_stats
from ..ops.pcc_scan import pcc_diff_counts


def threshold_counts(z_inter, z_nor, lo: float, hi: float) -> Tuple[int, int]:
    """(#entries < lo, #entries > hi) over the dense diff matrix (diagonal
    zeroed; the reference's statistics.py:44-45), on the factors' device."""
    return pcc_diff_counts(z_inter, z_nor, lo, hi)


def colocalization_counts(
    pairs: np.ndarray, loc_mat: np.ndarray
) -> Dict[str, int]:
    """both/single/none annotation coverage and same/diff-organelle counts
    for an (E, 2) edge-index array (the reference's statistics.py:114-165)."""
    if len(pairs) == 0:
        return {"both": 0, "single": 0, "none": 0, "same": 0, "diff": 0}
    loc_any = loc_mat.sum(1) > 0
    a = pairs[:, 0]
    b = pairs[:, 1]
    both = loc_any[a] & loc_any[b]
    single = loc_any[a] ^ loc_any[b]
    shared = (loc_mat[a] * loc_mat[b]).sum(1) > 0
    return {
        "both": int(both.sum()),
        "single": int(single.sum()),
        "none": int((~(loc_any[a] | loc_any[b])).sum()),
        "same": int((both & shared).sum()),
        "diff": int((both & ~shared).sum()),
    }


def topology_statistics(
    data_root: str,
    datasets: Sequence[Tuple[str, float]] = (
        ("GSE30931", 2.75), ("GSE74572", 2.91), ("GSE27182", 2.99),
    ),
    verbose: bool = True,
    device="cuda",
) -> Dict[str, Dict]:
    """Full statistics report; appends to log/statistics.txt like the
    reference (statistics.py:17).  The factors, their statistics and the
    threshold counts are computed on ``device``."""
    gm = os.path.join(data_root, "generate_materials")
    log_dir = os.path.join(data_root, "log")
    os.makedirs(log_dir, exist_ok=True)
    out = print if verbose else (lambda *a, **k: None)

    ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz")).tocsr()
    loc_mat = sp.load_npz(os.path.join(gm, "loc_matrix.npz")).toarray()
    results: Dict[str, Dict] = {}

    with open(os.path.join(log_dir, "statistics.txt"), "a") as f:
        for name, thr in datasets:
            path = os.path.join(gm, f"{name}_data")
            f.write("#" * 20 + " " + name + " " + "#" * 20 + "\n")

            expr_n = np.load(os.path.join(path, "expr_normal.npy"))
            expr_i = np.load(os.path.join(path, "expr_inter.npy"))
            z_n = pcc_factors_torch(expr_n, device)
            z_i = pcc_factors_torch(expr_i, device)
            mean, std = diff_stats(z_i, z_n)
            lo, hi = mean - thr * std, mean + thr * std

            n = ppi.shape[0]
            pcc_all = n * n
            conn = int(ppi.nnz)
            l_num, r_num = threshold_counts(z_i, z_n, lo, hi)

            inter = sp.load_npz(os.path.join(path, "PPI_inter.npz")).tocoo()
            # removed = normal edges absent from inter; added = inter edges
            # absent from normal.
            nor = ppi.tocoo()
            nor_set = sp.csr_matrix(
                (np.ones(nor.nnz), (nor.row, nor.col)), shape=ppi.shape
            )
            int_set = sp.csr_matrix(
                (np.ones(inter.nnz), (inter.row, inter.col)), shape=ppi.shape
            )
            removed = (nor_set - nor_set.multiply(int_set)).tocoo()
            added = (int_set - int_set.multiply(nor_set)).tocoo()
            res11, res22 = removed.nnz, added.nnz
            alt_conn = int(int_set.nnz)

            out(path)
            out("Threshold: ", thr)
            out("Differential PCC values of protein pairs: ", pcc_all)
            out("Interactions in the control state: ", conn)
            out("Lower than the lower threshold value: ", l_num,
                "  Percentage: ", l_num / pcc_all * 100)
            out("Higher than the upper threshold value: ", r_num,
                "  Percentage: ", r_num / pcc_all * 100)
            f.write(
                "########## Threshold: " + str(thr) + " ##########\n"
                + "Differential PCC values of protein pairs: " + str(pcc_all) + "\n"
                + "Interactions in the control state: " + str(conn) + "\n"
                + "Lower than the lower threshold value: " + str(l_num)
                + "  Percentage: " + str(l_num / pcc_all * 100) + "\n"
                + "Higher than the upper threshold value: " + str(r_num)
                + "  Percentage: " + str(r_num / pcc_all * 100) + "\n"
            )
            out("number of connection after mod: ", alt_conn)
            out("Removed: ", res11,
                "  Percentage(before the topology adjustment): ",
                res11 / conn * 100)
            out("Added: ", res22,
                "  Percentage(after the topology adjustment): ",
                res22 / alt_conn * 100)
            f.write(
                "Removed: " + str(res11)
                + "  Percentage(before the topology adjustment): "
                + str(res11 / conn * 100) + "\n"
                + "Added: " + str(res22)
                + "  Percentage(after the topology adjustment): "
                + str(res22 / alt_conn * 100) + "\n"
            )

            add_pairs = np.stack([added.row, added.col], 1)
            rmv_pairs = np.stack([removed.row, removed.col], 1)
            nor_pairs = np.stack([nor.row, nor.col], 1)
            ac = colocalization_counts(add_pairs, loc_mat)
            rc = colocalization_counts(rmv_pairs, loc_mat)
            nc = colocalization_counts(nor_pairs, loc_mat)

            f.write(
                "Both interacting proteins with annotations & established: "
                + str(ac["both"]) + "\n"
                + "\tInteractions happen within the same subcellular organelle: "
                + str(ac["same"]) + "\n"
                + "\tInteractions happen across different subcellular organelles: "
                + str(ac["diff"]) + "\n"
                + "Both interacting proteins with annotations & removed: "
                + str(rc["both"]) + "\n"
                + "\tInteractions happen within the same subcellular organelle: "
                + str(rc["same"]) + "\n"
                + "\tInteractions happen across different subcellular organelles: "
                + str(rc["diff"]) + "\n"
            )
            f.write(
                "Interactions have both interacting proteins with annotations: "
                + str(nc["same"] + nc["diff"]) + "\n"
                + "\tInteractions happen within the same subcellular organelle: "
                + str(nc["same"]) + "\n"
                + "\tInteractions happen across different subcellular organelles: "
                + str(nc["diff"]) + "\n\n"
            )
            results[name] = {
                "mean": mean, "std": std, "l_num": l_num, "r_num": r_num,
                "removed": res11, "added": res22, "conn": conn,
                "alt_conn": alt_conn, "add_coloc": ac, "rmv_coloc": rc,
                "normal_coloc": nc,
            }
        f.write("#" * 60 + "\n\n")
    return results
