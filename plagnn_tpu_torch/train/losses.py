"""Loss and class-weight functions.

Port of ``plagnn_tpu/train/losses.py`` (the reference's ``multi_loss`` and
``weight_cal``), as masked whole-graph reductions that broadcast over a
leading fold axis.
"""
from __future__ import annotations

import numpy as np
import torch


def weight_cal(loc_mat: np.ndarray) -> np.ndarray:
    """Per-class weights ``w_i = (n_labeled - n_i) / n_i`` from the full
    localization matrix; ``n_labeled`` counts rows with >= 1 annotation."""
    loc_mat = np.asarray(loc_mat)
    class_num = loc_mat.sum(axis=0)
    sample_num = int((loc_mat.sum(axis=1) > 0).sum())
    return (sample_num - class_num) / class_num


def multi_loss(
    probs: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    class_weight: torch.Tensor,
) -> torch.Tensor:
    """Weighted multi-label BCE.

    probs (..., N, C), targets (N, C), mask (..., N) bool, class_weight (C,)
    -> (...,).  Per class i:
        L_i = -sum_rows [ t.log(clamp(p,1e-9,10)).w_i
                          + (1-t).log(clamp(1-p,1e-9,10)) ] / (w_i+1) . 2 / n
    summed over classes; ``n`` is the number of masked rows.
    """
    mask = mask.to(probs.dtype)
    n = torch.clamp(mask.sum(-1), min=1.0)
    w = class_weight.to(probs.dtype)
    ll = (
        targets * torch.log(torch.clamp(probs, 1e-9, 10.0)) * w
        + (1.0 - targets) * torch.log(torch.clamp(1.0 - probs, 1e-9, 10.0))
    ) / (w + 1.0) * 2.0
    per_class = -(ll * mask[..., None]).sum(-2) / n[..., None]
    return per_class.sum(-1)
