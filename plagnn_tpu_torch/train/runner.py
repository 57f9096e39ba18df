"""The fold-batched runner: one epoch and the loop over epochs.

One epoch is forward -> masked weighted BCE per fold -> backward -> one
Adam step over the fold-stacked parameters -> adaptive threshold ->
AIM/COV/mlACC, F1 and sampled AUC, all on the device.  The metric history
stays on the device until the run ends and is copied to the host once.
``EpochTimer`` times each epoch's phases (``EPOCH_PHASES``) on the device's
clock, and each phase is a span of ``utils/profiling.py``.

``make_fold_runner`` takes the forward and the collectives as callables,
so the single-device runner (``train.engine.make_batched_fold_runner``)
and the sharded one (``parallel.sharded.make_sharded_fold_runner``) share
the epoch: the sharded one adds the sums of the loss and the gradients
over its graph group, gathers the probabilities over it, and gathers the
folds over its fold group.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils import profiling
from .losses import bce_from_sums, masked_bce_sums, multi_loss
from .metrics import aim_cov_acc, macro_auc, macro_f1, micro_auc, micro_f1
from .postprocess import protein_loc_correction

# Layout of one epoch's per-fold history row (then pred_num's C counts).
HIST_COLS = (("train", "aim"), ("train", "cov"), ("train", "acc"),
             ("train", "loss"), ("val", "aim"), ("val", "cov"),
             ("val", "acc"), ("val", "loss"), ("val", "f1_micro"),
             ("val", "f1_macro"), ("val", "auc_micro"), ("val", "auc_macro"))

# The phases of an epoch, in order (EpochTimer's rows; auc only on the
# epochs that sample the AUC, 0 on the others).
EPOCH_PHASES = ("forward", "backward", "adam", "metrics", "auc")

Reduce = Callable[[torch.Tensor], None]          # in place
Gather = Callable[[torch.Tensor], torch.Tensor]


def make_adam(model: torch.nn.Module, cfg) -> torch.optim.Adam:
    """One Adam state over the fold-stacked parameters (optax.adam's
    update: eps outside the square root, no weight decay).  The span
    ``setup.optimizer_init`` holds the first call's import of
    ``torch._dynamo``."""
    with profiling.span("setup.optimizer_init"):
        return torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8)


def auc_sample_now(e_idx: int, n_epochs: int, auc_every: int) -> bool:
    """On-cadence epochs and the final epoch (global indices)."""
    return e_idx % auc_every == 0 or e_idx == n_epochs - 1


class EpochTimer:
    """Per-epoch wall time and its phases, read once at the end (CUDA events
    on a card, the host clock on the CPU).  An epoch is ``start()`` and then
    ``mark(phase)`` where each phase ends: the time since the previous mark
    is the phase's, and the last mark ends the epoch.  Consecutive marks
    share one event."""

    # Events that a timer has read, by device index, for the next timer to
    # record again: creating a CUDA event costs host time at every mark.
    _free_events: Dict[int, List[torch.cuda.Event]] = {}

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.epochs: List[list] = []
        if self.cuda:
            self.stream = torch.cuda.current_stream()
            self.free = EpochTimer._free_events.setdefault(self.stream.device_index, [])

    def start(self):
        self.epochs.append([(None, self._mark())])

    def mark(self, phase: str):
        self.epochs[-1].append((phase, self._mark()))

    @contextlib.contextmanager
    def phase(self, name: str):
        """The block as the phase ``name``: a span ``runner.<name>`` that
        ends with the phase's mark."""
        with profiling.span(f"runner.{name}"):
            yield
            self.mark(name)

    def _mark(self):
        if self.cuda:
            ev = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            return ev
        return time.perf_counter()

    def elapsed_ms(self) -> List[float]:
        """Each epoch's ms, first mark to last; also appends each epoch's
        row of EPOCH_PHASES -> ms to ``profiling.PHASES``."""
        if self.cuda:
            torch.cuda.synchronize()

            def ms(a, b):
                return a.elapsed_time(b)
        else:
            def ms(a, b):
                return (b - a) * 1e3
        out = []
        for marks in self.epochs:
            row = dict.fromkeys(EPOCH_PHASES, 0.0)
            for (_, a), (phase, b) in zip(marks, marks[1:]):
                row[phase] += ms(a, b)
            profiling.PHASES.append(row)
            out.append(ms(marks[0][1], marks[-1][1]))
        if self.cuda:
            self.free.extend(ev for marks in self.epochs for _, ev in marks)
        self.epochs = []
        return out


def make_fold_runner(
    forward: Callable[[torch.nn.Module], torch.Tensor],
    labels: torch.Tensor,
    class_weight,
    node_valid: torch.Tensor,
    cfg,
    *,
    local_labels: Optional[torch.Tensor] = None,
    local_masks: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    all_reduce: Optional[Reduce] = None,
    gather_rows: Optional[Gather] = None,
    fold_slice: Optional[Callable[[int], slice]] = None,
    gather_folds: Optional[Gather] = None,
):
    """run(model, opt, train_masks (B, N), val_masks (B, N), alpha, n_epochs,
    epoch_offset, total_epochs, last_auc) -> (model, opt, last_probs (B, N,
    C), history, epoch_ms), history a dict of numpy (B, E) arrays plus
    pred_num (B, E, C) int32.  ``last_auc`` carries the sampled AUC pair
    into a later stretch of epochs (default 0.5 each).

    forward(model) -> (R, B_l, C) probabilities of this rank's rows; labels
    (N, C) and node_valid (N,) on the device.  One device: R = N and
    nothing else is given.  A graph shard adds ``local_labels`` (R, C),
    ``local_masks`` (B_l, N) -> (B_l, R), ``all_reduce`` (the loss sums
    and the gradients over its graph group) and ``gather_rows`` ((B_l, R,
    C) -> (B_l, N, C)); a fold group ``fold_slice`` (B -> its folds of
    the B) and ``gather_folds`` (dim 0 over the fold groups).

    Reference quirks kept: the val loss and the predictions use the
    pre-update forward; the training loss is the sum of per-fold losses,
    so each fold's gradient is its own."""
    device = labels.device
    n_rows = labels.shape[0]
    w = torch.as_tensor(np.asarray(class_weight), dtype=torch.float32, device=device)
    auc_every = max(int(cfg.auc_every or 1), 1)
    n_metric = len(HIST_COLS)
    y_local = labels if local_labels is None else local_labels

    def epoch(model, opt, tr_local, tr_masks, va_masks, alpha, e_idx, n_epochs,
              last_auc, timer):
        with timer.phase("forward"):
            probs = forward(model).transpose(0, 1)           # (B_l, R, C)
        with timer.phase("backward"):
            sums, count = masked_bce_sums(probs, y_local, tr_local, w)
            tot_sums, tot_count = sums.detach(), count
            if all_reduce is not None:
                st = torch.cat([tot_sums, count[:, None]], dim=-1)
                all_reduce(st)
                tot_sums, tot_count = st[:, :-1], st[:, -1]
            opt.zero_grad(set_to_none=True)
            bce_from_sums(sums, tot_count).sum().backward()
            if all_reduce is not None:
                grads = [q.grad for q in model.parameters()]
                flat = torch.cat([g.reshape(-1) for g in grads])
                all_reduce(flat)
                for g, v in zip(grads, flat.split([g.numel() for g in grads])):
                    g.copy_(v.view_as(g))
            # the autograd graph is freed here, not where the epoch returns;
            # the val loss and the predictions read the PRE-update forward
            del sums
            probs = probs.detach()
        with timer.phase("adam"):
            opt.step()
        with torch.no_grad(), profiling.span("runner.metrics"):
            train_losses = bce_from_sums(tot_sums, tot_count)
            if gather_rows is not None:
                probs = gather_rows(probs)                   # (B_l, N, C)
            if cfg.compute_auc and auc_sample_now(e_idx, n_epochs, auc_every):
                timer.mark("metrics")
                with timer.phase("auc"):
                    last_auc = (micro_auc(probs, labels, va_masks),
                                macro_auc(probs, labels, va_masks))
            with profiling.span("metrics.multi_loss"):
                val_losses = multi_loss(probs, labels, va_masks, w)
            with profiling.span("metrics.protein_loc_correction"):
                preds = protein_loc_correction(probs, alpha, node_valid)
            with profiling.span("metrics.aim_cov_acc"):
                tr_m = aim_cov_acc(labels, preds, tr_masks)
                va_m = aim_cov_acc(labels, preds, va_masks)
            with profiling.span("metrics.f1"):
                f1 = (micro_f1(labels, preds, va_masks), macro_f1(labels, preds, va_masks))
            with profiling.span("metrics.row"):
                pred_num = torch.where(node_valid[:, None], preds, 0.0).sum(-2)
                cols = torch.stack([*tr_m, train_losses, *va_m, val_losses, *f1, *last_auc],
                                   dim=-1)
            # The epoch's last launch, after the last span inside the epoch
            # has closed: in a profiled run a range's close costs host time,
            # and host time after the last launch is device idle.
            row = torch.cat([cols, pred_num], dim=-1)
            timer.mark("metrics")
        return probs, row, last_auc

    def run(model, opt, train_masks, val_masks, alpha: float,
            n_epochs: Optional[int] = None, epoch_offset: int = 0,
            total_epochs: Optional[int] = None, last_auc=None):
        with profiling.span("runner.run"):
            if opt is None:
                opt = make_adam(model, cfg)
            n_run = n_epochs or cfg.epoch_num
            total = total_epochs or (epoch_offset + n_run)
            folds = slice(None) if fold_slice is None else fold_slice(train_masks.shape[0])
            tr_masks = torch.as_tensor(train_masks, device=device)[folds, :n_rows]
            va_masks = torch.as_tensor(val_masks, device=device)[folds, :n_rows]
            tr_local = tr_masks if local_masks is None else local_masks(tr_masks)
            b = tr_masks.shape[0]
            if last_auc is None:
                last_auc = (torch.full((b,), 0.5, device=device),
                            torch.full((b,), 0.5, device=device))
            else:
                last_auc = tuple(torch.as_tensor(a, device=device)[folds] for a in last_auc)
            rows = []
            timer = EpochTimer(device)
            probs = None
            for e in range(epoch_offset, epoch_offset + n_run):
                with profiling.span("runner.epoch"):
                    timer.start()
                    probs, row, last_auc = epoch(model, opt, tr_local, tr_masks, va_masks,
                                                 alpha, e, total, last_auc, timer)
                    rows.append(row)
            with profiling.span("runner.stretch_end"):
                hist = torch.stack(rows, dim=1)                  # (B_l, E, 12 + C)
                if gather_folds is not None:
                    hist, probs = gather_folds(hist), gather_folds(probs)
                hist = hist.cpu().numpy()
                epoch_ms = timer.elapsed_ms()
                history = {"train": {}, "val": {}}
                for i, (split, key) in enumerate(HIST_COLS):
                    if key.startswith("auc") and not cfg.compute_auc:
                        continue
                    history[split][key] = hist[:, :, i]
                history["pred_num"] = hist[:, :, n_metric:].astype(np.int32)
            return model, opt, probs, history, epoch_ms

    return run
