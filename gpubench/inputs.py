"""The cell's inputs, made from ``--seed`` on the run's device.

Every input comes from its own ``torch.Generator`` stream, derived from the
seed and the stream's name, in a few large calls:

* the graph: a configuration model with power-law endpoint weights
  ``i ** (-1 / (gamma - 1))`` (gamma 2.2), self pairs and duplicate pairs
  dropped, exactly ``edges / 2`` undirected pairs kept and both directions
  emitted.  Self-loops are added by the program and by the reference.
* the features: the reference's 503-wide block layout (utils.py:46-49): 3
  expression columns ~ Gamma(2, 2), 250 GCN-PCA ~ N(0, 0.5^2), 250 ECC-PCA
  ~ N(0, 0.3^2); padding rows zero.
* the labels: a multi-label matrix over ``labeled_frac`` of the nodes, class
  rates geometric from ``class_p[0]`` to ``class_p[1]``, each labelled node
  with at least one class, each class with at least one node.
* K-fold masks over the labelled nodes: ``fold_batch`` folds, taken round
  by round from a fresh shuffled ``fold_num``-fold split each.
* the initial fold-stacked weights, each with its layer kind's init law
  (``kinds/<kind>.py``).

The same seed gives the same inputs; every seed gives the same sizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference.model import load_kind

# Padded node count as the port's kernels take it: a dedicated dummy row,
# then a multiple of 128 (plagnn_tpu_torch/ops/graph_format.py).
NODE_MULTIPLE = 128


def padded_nodes(n: int) -> int:
    return -(-(n + 1) // NODE_MULTIPLE) * NODE_MULTIPLE


def stream(seed: int, name: str, device) -> torch.Generator:
    """The generator of one input stream of ``seed``."""
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    tag = int.from_bytes(name.encode(), "little") % (1 << 63)
    state = np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


@dataclasses.dataclass
class Inputs:
    n: int                      # real nodes
    n_pad: int
    src: torch.Tensor           # (E,) int64, both directions, no self pairs
    dst: torch.Tensor
    feats: torch.Tensor         # (n_pad, F) float32
    labels: torch.Tensor        # (n_pad, C) float32 {0, 1}
    label_idx: torch.Tensor     # (L,) int64 labelled nodes, ascending
    train_masks: torch.Tensor   # (B, n_pad) bool
    val_masks: torch.Tensor     # (B, n_pad) bool
    weights: Dict[str, torch.Tensor]   # name -> (B, ...) float32


def powerlaw_edges(n: int, n_edges: int, gamma: float,
                   gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) of ``n_edges`` directed edges: ``n_edges // 2`` distinct
    undirected pairs, no self pairs, each pair in both directions."""
    dev = gen.device
    w = torch.arange(1, n + 1, device=dev, dtype=torch.float64).pow(-1.0 / (gamma - 1.0))
    m = n_edges // 2
    k = int(m * 1.3) + 16          # oversampled against dropped pairs
    a = torch.multinomial(w, k, replacement=True, generator=gen)
    b = torch.multinomial(w, k, replacement=True, generator=gen)
    keep = a != b
    a, b = a[keep], b[keep]
    key = torch.unique(torch.minimum(a, b) * n + torch.maximum(a, b))
    if key.numel() < m:
        raise ValueError(f"only {key.numel()} distinct pairs for {m} asked: the traffic's "
                         "edge count is too high for its node count")
    key = key[torch.randperm(key.numel(), generator=gen, device=dev)[:m]]
    lo, hi = key // n, key % n
    return torch.cat([lo, hi]), torch.cat([hi, lo])


def features(n: int, n_pad: int, blocks: Dict[str, int],
             gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    n_expr, n_gcn, n_ecc = blocks["expr"], blocks["gcn_pca"], blocks["ecc_pca"]
    out = torch.zeros((n_pad, n_expr + n_gcn + n_ecc), device=dev)
    u = torch.rand((2, n, n_expr), generator=gen, device=dev)
    out[:n, :n_expr] = -2.0 * torch.log1p(-u).sum(0)      # Gamma(2, scale 2)
    z = torch.randn((n, n_gcn + n_ecc), generator=gen, device=dev)
    out[:n, n_expr:n_expr + n_gcn] = z[:, :n_gcn] * 0.5
    out[:n, n_expr + n_gcn:] = z[:, n_gcn:] * 0.3
    return out


def loc_matrix(n: int, n_pad: int, n_classes: int, labeled_frac: float,
               class_p: List[float], gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    p = torch.as_tensor(np.geomspace(class_p[0], class_p[1], n_classes), device=dev,
                        dtype=torch.float32)
    labeled = torch.rand(n, generator=gen, device=dev) < labeled_frac
    lab = (torch.rand((n, n_classes), generator=gen, device=dev) < p) & labeled[:, None]
    pick = torch.randint(0, 3, (n,), generator=gen, device=dev)
    need = labeled & ~lab.any(1)
    lab[need, pick[need]] = True
    fill = torch.randint(0, n, (n_classes,), generator=gen, device=dev)
    empty = ~lab.any(0)
    lab[fill[empty], torch.nonzero(empty).squeeze(1)] = True
    out = torch.zeros((n_pad, n_classes), device=dev)
    out[:n] = lab.float()
    return out


def fold_masks(label_idx: torch.Tensor, n_pad: int, fold_num: int, fold_batch: int,
               gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(train, val) masks (fold_batch, n_pad).  Fold ``f`` is fold
    ``f % fold_num`` of round ``f // fold_num``; each round draws its own
    shuffled ``fold_num``-fold split of the labelled nodes from ``gen``, in
    order (the first ``L % fold_num`` folds one larger, as KFold cuts
    them)."""
    dev = label_idx.device
    n_lab = label_idx.numel()
    sizes = [n_lab // fold_num + (f < n_lab % fold_num) for f in range(fold_num)]
    train = torch.zeros((fold_batch, n_pad), dtype=torch.bool, device=dev)
    val = torch.zeros_like(train)
    for f in range(fold_batch):
        if f % fold_num == 0:
            order = label_idx[torch.randperm(n_lab, generator=gen, device=dev)]
            start = 0
        size = sizes[f % fold_num]
        train[f, label_idx] = True
        va = order[start:start + size]
        train[f, va] = False
        val[f, va] = True
        start += size
    return train, val


def param_laws(config: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(parameter name, shape of one fold's leaf, bound) of every leaf of the
    configuration's layers, in draw order: U(-bound, bound), bound 0 for a
    zero init.  Each layer's kind gives its leaves' laws (``leaves`` of
    ``kinds/<kind>.py``); a leaf is named ``<layer name>.<leaf>``."""
    return [(f"{layer['name']}.{leaf}", shape, bound)
            for layer in config["layers"]
            for leaf, shape, bound in load_kind(layer["kind"]).leaves(layer)]


def init_weights(config: dict, folds: int, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every fold's initial leaves, drawn in one call."""
    laws = param_laws(config)
    sizes = [folds * math.prod(shape) if bound else 0 for _, shape, bound in laws]
    flat = torch.rand(sum(sizes), generator=gen, device=gen.device) * 2.0 - 1.0
    out = {}
    for (name, shape, bound), part in zip(laws, flat.split(sizes)):
        out[name] = (part.view(folds, *shape) * bound if bound
                     else torch.zeros((folds, *shape), device=gen.device))
    return out


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    n = traffic["nodes"]
    n_pad = padded_nodes(n)
    src, dst = powerlaw_edges(n, traffic["edges"], traffic["gamma"],
                              stream(seed, "graph", device))
    feats = features(n, n_pad, config["features"], stream(seed, "features", device))
    if feats.shape[1] != config["in_feats"]:
        raise ValueError(f"feature blocks give {feats.shape[1]} columns, the model takes "
                         f"{config['in_feats']}")
    labels = loc_matrix(n, n_pad, config["num_classes"], traffic["labeled_frac"],
                        traffic["class_p"], stream(seed, "labels", device))
    label_idx = torch.nonzero(labels.any(1)).squeeze(1)
    train, val = fold_masks(label_idx, n_pad, config["fold_num"], traffic["fold_batch"],
                            stream(seed, "folds", device))
    weights = init_weights(config, traffic["fold_batch"], stream(seed, "weights", device))
    return Inputs(n=n, n_pad=n_pad, src=src, dst=dst, feats=feats, labels=labels,
                  label_idx=label_idx, train_masks=train, val_masks=val, weights=weights)
