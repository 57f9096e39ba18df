"""The system under test: the port's fold-batched runner on the cell's graph.

``Program`` builds what ``plagnn_tpu_torch.train.engine.train`` builds for one
fold batch on one card (the port's graph with the hub that ``hub_cache``
resolves to, the runner of ``make_batched_fold_runner``, the model of
``init_fold_model`` with the benchmark's weights loaded into it, Adam from
``make_adam``) and calls ``run`` in stretches over 200-epoch rounds as
``train`` does with ``checkpoint_every``: ``epoch_offset`` and
``total_epochs`` follow the round's global epochs, and the sampled AUC pair
is carried from one stretch into the next.  A round that ends starts again
from the benchmark's initial weights with a fresh Adam.  The configuration
gives the aggregation dtype (``agg_dtype``, float32 by default).

``plant`` switches on one of the faults or the control that the check of
``correct`` has to catch (``checks.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from .inputs import Inputs

AUC_KEYS = ("auc_micro", "auc_macro")
HIST_SPLITS = {"train": ("aim", "cov", "acc", "loss"),
               "val": ("aim", "cov", "acc", "loss", "f1_micro", "f1_macro", "auc_micro",
                       "auc_macro")}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Snapshot:
    """What the program produced in a round's first steps, on the host."""

    probs: List[torch.Tensor]                # per step (B, n, C), real rows
    rows: List[Dict[str, torch.Tensor]]      # per step: "split.key" -> (B,)
    grad1: Dict[str, torch.Tensor]           # the first gradient, as Adam holds it
    theta: Dict[str, torch.Tensor]           # the leaves after the last step


class Program:
    def __init__(self, config: dict, traffic: dict, inputs: Inputs, device):
        from plagnn_tpu_torch.ops.graph_format import build_graph
        from plagnn_tpu_torch.train import engine, losses, runner
        from plagnn_tpu_torch.utils.precision import set_aggregation_dtype

        self.device = torch.device(device)
        # every Program sets it, so a process that runs several cells
        # carries no cell's dtype into the next
        set_aggregation_dtype(config.get("agg_dtype", "float32"))
        self.cfg = engine.TrainConfig(
            lr=config["lr"], fold_num=config["fold_num"], epoch_num=config["epoch_num"],
            alpha_list=(config["alpha"],), fold_batch=traffic["fold_batch"],
            model=config["model"], hidden=tuple(config["hidden"]),
            num_classes=config["num_classes"], compute_auc=True,
            auc_every=traffic["auc_every"], verbose=False, hub_cache=config["hub_cache"])
        self.n = inputs.n
        self.alpha = float(config["alpha"])
        self.stretch_epochs = traffic["stretch_epochs"]

        t0 = time.perf_counter()
        graph = build_graph(inputs.src.cpu().numpy(), inputs.dst.cpu().numpy(), inputs.n,
                            add_self_loops=traffic["self_loops"])
        self.hub = engine.resolve_hub(self.cfg, graph, config["in_feats"])
        if any(self.hub):
            graph = graph.with_hub(*self.hub)
        graph = graph.to(self.device)
        sync(self.device)
        self.graph_build_s = time.perf_counter() - t0
        if graph.n_nodes != inputs.n_pad:
            raise RuntimeError(f"the port padded {inputs.n} nodes to {graph.n_nodes} rows, "
                               f"the benchmark to {inputs.n_pad}")

        class_weight = losses.weight_cal(inputs.labels[:inputs.n].cpu().numpy())
        node_valid = torch.arange(inputs.n_pad, device=self.device) < inputs.n
        self.run = engine.make_batched_fold_runner(graph, inputs.feats, inputs.labels,
                                                   class_weight, node_valid, self.cfg)
        self.model = engine.init_fold_model(self.cfg, config["in_feats"],
                                            list(range(traffic["fold_batch"])), self.device)
        self.init = inputs.weights
        params = dict(self.model.named_parameters())
        if set(params) != set(self.init) or any(
                params[k].shape != self.init[k].shape for k in params):
            raise RuntimeError("the port's model has other leaves than the configuration: "
                               f"{sorted((k, tuple(v.shape)) for k, v in params.items())}")
        self.params = params
        self.make_adam = lambda: runner.make_adam(self.model, self.cfg)
        self.train_masks, self.val_masks = inputs.train_masks, inputs.val_masks
        self.reset_round()

    def reset_round(self) -> None:
        """Epoch 0 of a round: the initial weights, a fresh Adam."""
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(self.init[k])
        self.opt = self.make_adam()
        self.epoch = 0
        self.last_auc = None

    def epochs(self, n: int):
        """``run`` over the next ``n`` epochs of the round; a round that ends
        is reset.  Returns (last probs, history, epoch_ms)."""
        _, self.opt, probs, hist, ms = self.run(
            self.model, self.opt, self.train_masks, self.val_masks, self.alpha,
            n_epochs=n, epoch_offset=self.epoch, total_epochs=self.cfg.epoch_num,
            last_auc=self.last_auc)
        self.last_auc = tuple(torch.as_tensor(hist["val"][k][:, -1], device=self.device)
                              for k in AUC_KEYS)
        self.epoch += n
        if self.epoch == self.cfg.epoch_num:
            self.reset_round()
        return probs, hist, ms

    @staticmethod
    def launches() -> Dict[str, int]:
        """The port's aggregation kernel launch counters as they stand (the
        port counts launches on a card only)."""
        from plagnn_tpu_torch.ops.spmm_kernels import LAUNCHES

        return dict(LAUNCHES)

    @staticmethod
    def message_dtype() -> str:
        """The port's aggregation dtype as it stands: float32 or bfloat16."""
        from plagnn_tpu_torch.utils.precision import aggregation_dtype

        dtype = aggregation_dtype()
        return "float32" if dtype is None else str(dtype).removeprefix("torch.")

    def next_stretch(self) -> int:
        """Epochs to the next stretch boundary (or the round's end)."""
        return min(self.stretch_epochs - self.epoch % self.stretch_epochs,
                   self.cfg.epoch_num - self.epoch)

    def first_steps(self, n_steps: int) -> Snapshot:
        """A round's first ``n_steps`` epochs, one ``run`` call each, and what
        they produced."""
        if self.epoch != 0:
            raise RuntimeError("the checked steps start a round")
        probs, rows, grad1 = [], [], {}
        for step in range(n_steps):
            p, hist, _ = self.epochs(1)
            probs.append(p[:, :self.n].float().cpu())
            rows.append({f"{s}.{k}": torch.as_tensor(hist[s][k][:, 0]).double()
                         for s, keys in HIST_SPLITS.items() for k in keys})
            if step == 0:
                beta1 = self.opt.param_groups[0]["betas"][0]
                state = self.opt.state
                grad1 = {k: (state[p]["exp_avg"] / (1 - beta1)).cpu() if p in state
                         else torch.zeros(p.shape) for k, p in self.params.items()}
        theta = {k: p.detach().cpu().clone() for k, p in self.params.items()}
        return Snapshot(probs=probs, rows=rows, grad1=grad1, theta=theta)


# ---------------------------------------------------------------------------
# Faults and the control.
# ---------------------------------------------------------------------------

PLANTS = ("control", "state_unchanged", "half_batch", "answer")


@contextlib.contextmanager
def plant(name: Optional[str]):
    """The program with one fault (or the control) switched on:

    * ``control``: the port's own lower-precision path, TF32 matmuls
      (``utils.precision.set_matmul_precision('high')``);
    * ``state_unchanged``: Adam's step leaves the weights and its state as
      they were;
    * ``half_batch``: the loss takes each fold's first half of its training
      rows and its mean over them;
    * ``answer``: the threshold correction's decisions for class 0 of fold 0
      flipped where they are made (the metric row's answers).
    """
    from plagnn_tpu_torch.train import runner
    from plagnn_tpu_torch.utils import precision

    if name is None:
        yield
        return
    if name == "control":
        before = precision.matmul_precision()
        precision.set_matmul_precision("high")
        try:
            yield
        finally:
            precision.set_matmul_precision(before)
        return
    if name == "state_unchanged":
        target, attr = torch.optim.Adam, "step"

        def broken(self, closure=None):
            return None
    elif name == "half_batch":
        target, attr = runner, "masked_bce_sums"
        sound = runner.masked_bce_sums

        def broken(probs, targets, mask, class_weight):
            first_half = mask & (mask.cumsum(-1) <= (mask.sum(-1, keepdim=True) + 1) // 2)
            return sound(probs, targets, first_half, class_weight)
    elif name == "answer":
        target, attr = runner, "protein_loc_correction"
        sound = runner.protein_loc_correction

        def broken(loc_proba, alpha, row_valid=None):
            pred = sound(loc_proba, alpha, row_valid).clone()
            pred[0, :, 0] = torch.where(row_valid, 1.0 - pred[0, :, 0], 0.0)
            return pred
    else:
        raise ValueError(f"unknown plant {name!r}; one of {PLANTS}")
    saved = getattr(target, attr)
    setattr(target, attr, broken)
    try:
        yield
    finally:
        setattr(target, attr, saved)
