"""Prediction post-processing.

Port of ``plagnn_tpu/train/postprocess.py``: per-column min-max
normalization over the valid rows, per-row sum normalization, then a
per-row adaptive threshold ``rowmax - (rowmax - rowmin) . alpha`` with
strict ``>``.  The torch version broadcasts over a leading fold axis and
excludes padding rows; the numpy twin serves the host-side log writer and
the analysis, which also takes ``scaling_np``, the scoring's merge scaler.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def protein_loc_correction(
    loc_proba: torch.Tensor,
    alpha: float,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., N, C) probabilities -> float {0, 1} predictions, padding rows
    (``row_valid`` False) all zero and left out of the column statistics."""
    x = loc_proba
    if row_valid is None:
        row_valid = torch.ones(x.shape[-2], dtype=torch.bool, device=x.device)
    rv = row_valid[:, None]
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    min_p = torch.where(rv, x, inf).amin(-2, keepdim=True)
    max_p = torch.where(rv, x, -inf).amax(-2, keepdim=True)
    new = (x - min_p) / (max_p - min_p)
    new = new / new.sum(-1, keepdim=True)
    row_max = new.amax(-1)
    row_min = new.amin(-1)
    thresholds = row_max - (row_max - row_min) * alpha
    pred = (new > thresholds[..., None]).to(x.dtype)
    return torch.where(rv, pred, torch.zeros((), dtype=x.dtype, device=x.device))


def protein_loc_correction_np(loc_proba: np.ndarray, alpha: float) -> np.ndarray:
    """Numpy twin (the reference's performance.py semantics)."""
    x = np.asarray(loc_proba)
    min_p = x.min(0)
    max_p = x.max(0)
    new = (x - min_p) / (max_p - min_p)
    new = new / new.sum(1).reshape(-1, 1)
    thr = new.max(1) - (new.max(1) - new.min(1)) * alpha
    pred = np.zeros(x.shape)
    pred[new > thr[:, None]] = 1.0
    return pred


def scaling_np(logit_mat: np.ndarray) -> np.ndarray:
    """Column min-max + row sum-normalization (the reference's main.py:15-29),
    the merge scaler of the mis-localization scoring.  Dtype-preserving:
    float32 logits stay float32 and are upcast only by the float64
    accumulator of ``analysis.score.mat_merge``."""
    mat = np.array(logit_mat, copy=True)
    mat -= mat.min(0)
    mat /= mat.max(0)
    mat /= mat.sum(1).reshape(-1, 1)
    return mat

