"""The per-epoch metric row, plain, in float64.

For a fold's probabilities (n, C) of an epoch (before that epoch's update):

* the adaptive threshold (the source's protein_loc_correction): each column
  min-max scaled, each row divided by its sum, a class predicted where its
  value is strictly above ``rowmax - (rowmax - rowmin) * alpha``;
* AIM, COV and mlACC over the training rows and over the validation rows:
  the means over rows of |T & P| / |P| (0 where P is empty), |T & P| / |T|
  and |T & P| / |T | P| (0 where both are empty);
* the weighted BCE over each split;
* micro and macro F1 over the validation rows (0 where a class has no
  positive decision and no positive label);
* micro and macro AUC over the validation rows by the Mann-Whitney rank sum
  with average ranks for ties (0.5 where a class has one polarity), sampled
  on epochs ``e % auc_every == 0`` and the round's last, carried between
  samples, 0.5 before the first.

The columns are named as the runner's history names them.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .model import class_weights

COLUMNS = ("train.aim", "train.cov", "train.acc", "train.loss", "val.aim", "val.cov",
           "val.acc", "val.loss", "val.f1_micro", "val.f1_macro", "val.auc_micro",
           "val.auc_macro")


def loc_correction(p: torch.Tensor, alpha: float) -> torch.Tensor:
    mn, mx = p.min(0).values, p.max(0).values
    new = (p - mn) / (mx - mn)
    new = new / new.sum(1, keepdim=True)
    hi, lo = new.max(1).values, new.min(1).values
    return new > (hi - (hi - lo) * alpha)[:, None]


def aim_cov_acc(t: torch.Tensor, pred: torch.Tensor):
    inter = (t & pred).sum(1).double()
    n_pred = pred.sum(1).double()
    n_true = t.sum(1).double()
    union = (t | pred).sum(1).double()
    zero = torch.zeros_like(inter)
    aim = torch.where(n_pred > 0, inter / n_pred.clamp(min=1), zero).mean()
    cov = (inter / n_true.clamp(min=1)).mean()
    acc = torch.where(union > 0, inter / union.clamp(min=1), zero).mean()
    return aim, cov, acc


def loss(p: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    ll = (y * torch.log(p.clamp(1e-9, 10.0)) * w
          + (1.0 - y) * torch.log((1.0 - p).clamp(1e-9, 10.0))) / (w + 1.0) * 2.0
    return -(ll.sum(0) / max(p.shape[0], 1)).sum()


def f1(t: torch.Tensor, pred: torch.Tensor, dim=(0, 1)) -> torch.Tensor:
    tp = (t & pred).sum(dim).double()
    fp = (pred & ~t).sum(dim).double()
    fn = (t & ~pred).sum(dim).double()
    d = 2 * tp + fp + fn
    return torch.where(d > 0, 2 * tp / d.clamp(min=1), torch.zeros_like(d))


def auc(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mann-Whitney AUC of scores ``s`` against labels ``y`` (1-D)."""
    n_pos = int(y.sum())
    n_neg = y.numel() - n_pos
    if n_pos == 0 or n_neg == 0:
        return torch.tensor(0.5, dtype=torch.float64)
    _, inv, counts = torch.unique(s, return_inverse=True, return_counts=True)
    top = counts.cumsum(0).double()
    rank = (top - (counts.double() - 1) / 2)[inv]        # average 1-based rank
    return (rank[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def metric_rows(probs: List[torch.Tensor], labels: torch.Tensor, train_masks: torch.Tensor,
                val_masks: torch.Tensor, alpha: float, auc_every: int, epoch_num: int,
                first_epoch: int = 0) -> List[Dict[str, torch.Tensor]]:
    """The rows of consecutive epochs from ``first_epoch`` (a round's AUC
    carried from 0.5 at epoch 0), one per entry of ``probs`` ((B, n, C)
    each); each row maps a column to its (B,) values."""
    y = labels.double()
    t = labels > 0.5
    w = class_weights(labels)
    folds = train_masks.shape[0]
    carried = [(torch.tensor(0.5, dtype=torch.float64),) * 2 for _ in range(folds)]
    rows = []
    for step, pe in enumerate(probs):
        e = first_epoch + step
        sample = e % auc_every == 0 or e == epoch_num - 1
        cols = {c: [] for c in COLUMNS}
        for b in range(folds):
            p = pe[b].double()
            pred = loc_correction(p, alpha)
            for split, rows_b in (("train", train_masks[b]), ("val", val_masks[b])):
                for name, v in zip(("aim", "cov", "acc"), aim_cov_acc(t[rows_b], pred[rows_b])):
                    cols[f"{split}.{name}"].append(v)
                cols[f"{split}.loss"].append(loss(p[rows_b], y[rows_b], w))
            tv, pv = t[val_masks[b]], pred[val_masks[b]]
            cols["val.f1_micro"].append(f1(tv, pv))
            cols["val.f1_macro"].append(f1(tv, pv, 0).mean())
            if sample:
                sv = p[val_masks[b]]
                carried[b] = (auc(sv.reshape(-1), tv.reshape(-1)),
                              torch.stack([auc(sv[:, c], tv[:, c])
                                           for c in range(sv.shape[1])]).mean())
            cols["val.auc_micro"].append(carried[b][0])
            cols["val.auc_macro"].append(carried[b][1])
        rows.append({c: torch.stack(v) for c, v in cols.items()})
    return rows
