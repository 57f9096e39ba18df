"""Multi-label metrics as device reductions.

Port of ``plagnn_tpu/train/metrics.py``; every function broadcasts over a
leading fold axis (preds/scores (..., N, C), mask (..., N), true (N, C)):

    AIM   = mean_i |T_i & P_i| / |P_i|      (0 when |P_i| = 0)
    COV   = mean_i |T_i & P_i| / |T_i|
    mlACC = mean_i |T_i & P_i| / |T_i | P_i|   (Jaccard)

plus micro/macro F1 (sklearn zero_division=0 semantics) and a rank
(Mann-Whitney) AUC with average ranks for ties (``torch.sort`` +
``torch.searchsorted``).  ``micro_f1_np`` / ``macro_f1_np`` are the numpy
twins the host-side analysis uses.
"""
from __future__ import annotations

import numpy as np
import torch


def aim_cov_acc(loc_true, loc_pred, mask):
    """Masked AIM/COV/mlACC over rows selected by ``mask``."""
    t = loc_true > 0.5
    p = loc_pred > 0.5
    m = mask.float()
    n = torch.clamp(m.sum(-1), min=1.0)
    and_set = (t & p).sum(-1).float()
    pred = p.sum(-1).float()
    real = t.sum(-1).float()
    or_set = (t | p).sum(-1).float()
    zero = torch.zeros((), device=and_set.device)
    aim_i = torch.where(pred > 0, and_set / torch.clamp(pred, min=1.0), zero)
    cov_i = and_set / torch.clamp(real, min=1.0)
    acc_i = torch.where(or_set > 0, and_set / torch.clamp(or_set, min=1.0), zero)
    aim = (aim_i * m).sum(-1) / n
    cov = (cov_i * m).sum(-1) / n
    acc = (acc_i * m).sum(-1) / n
    return aim, cov, acc


def _masked_auc(scores, labels, valid):
    """Binary AUC over the last axis, average-rank ties, masked entries.

    Excluded entries get +inf scores: they sort above every real score and
    never enter the counts."""
    s = torch.where(valid, scores, torch.full_like(scores, float("inf")))
    pos = valid & (labels > 0.5)
    neg = valid & (labels <= 0.5)
    n_pos = pos.sum(-1)
    n_neg = neg.sum(-1)
    order = torch.sort(s, dim=-1).values
    lo = torch.searchsorted(order, s, side="left")
    hi = torch.searchsorted(order, s, side="right")
    ranks = 0.5 * (lo + hi + 1).float()  # average 1-based rank
    sum_pos_ranks = torch.where(pos, ranks, torch.zeros_like(ranks)).sum(-1)
    np_f = n_pos.float()
    nn_f = n_neg.float()
    auc = (sum_pos_ranks - np_f * (np_f + 1.0) / 2.0) / torch.clamp(np_f * nn_f, min=1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, torch.full_like(auc, 0.5))


def micro_auc(scores, labels, mask):
    """Micro-averaged multi-label AUC over masked rows (entries pooled)."""
    lead = scores.shape[:-2]
    valid = mask[..., None].expand(scores.shape).reshape(*lead, -1)
    lab = labels.expand(scores.shape).reshape(*lead, -1)
    return _masked_auc(scores.reshape(*lead, -1), lab, valid)


def macro_auc(scores, labels, mask):
    """Mean of per-class AUCs (a class with one label polarity counts 0.5)."""
    s = scores.transpose(-1, -2).contiguous()                 # (..., C, N)
    lab = labels.expand(scores.shape).transpose(-1, -2)
    valid = mask[..., None, :].expand(s.shape)
    return _masked_auc(s, lab, valid).mean(-1)


def _f1_counts(loc_true, loc_pred, mask, dims):
    t = (loc_true > 0.5) & mask[..., None]
    p = (loc_pred > 0.5) & mask[..., None]
    tp = (t & p).sum(dims).float()
    fp = (p & ~t).sum(dims).float()
    fn = (t & ~p).sum(dims).float()
    denom = 2.0 * tp + fp + fn
    return torch.where(denom > 0, 2.0 * tp / torch.clamp(denom, min=1.0),
                       torch.zeros_like(tp))


def micro_f1(loc_true, loc_pred, mask):
    """F1 = 2TP / (2TP + FP + FN) over all masked (row, class) decisions."""
    return _f1_counts(loc_true, loc_pred, mask, (-2, -1))


def macro_f1(loc_true, loc_pred, mask):
    """Unweighted mean of per-class F1s."""
    return _f1_counts(loc_true, loc_pred, mask, -2).mean(-1)


def micro_f1_np(loc_true, loc_pred) -> float:
    """numpy twin of :func:`micro_f1` for ``analysis.performance`` (callers
    pre-select rows, so no mask): the same 0.5 threshold and zero-division
    convention."""
    t = np.asarray(loc_true) > 0.5
    p = np.asarray(loc_pred) > 0.5
    tp = int(np.sum(t & p))
    fp = int(np.sum(p & ~t))
    fn = int(np.sum(t & ~p))
    d = 2 * tp + fp + fn
    return 2.0 * tp / d if d else 0.0


def macro_f1_np(loc_true, loc_pred) -> float:
    """numpy twin of :func:`macro_f1` (zero_division=0 semantics)."""
    t = np.asarray(loc_true) > 0.5
    p = np.asarray(loc_pred) > 0.5
    tp = np.sum(t & p, axis=0)
    fp = np.sum(p & ~t, axis=0)
    fn = np.sum(t & ~p, axis=0)
    d = 2 * tp + fp + fn
    return float(np.mean(np.where(d > 0, 2 * tp / np.maximum(d, 1), 0.0)))
