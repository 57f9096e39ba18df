"""Plain training steps of a configuration's layers, one fold at a time.

The semantics are those of the source (PLA-GNN's DGL model and train.py),
with the port's kernel contract where a library call would differ.  Each
layer's kind is a module of its own, ``kinds/<kind>.py`` (``load_kind``):
its leaves and init laws, its plain forward, its dense multiply-adds and its
aggregation bytes.  This module holds what the kinds share:

* ``first_max``: the maximum over in-edges, 0 for a row without in-edges;
  the gradient goes to the *first* maximum in (dst, src) order only (ties
  are common after a relu).  With bfloat16 messages the messages are
  rounded to bfloat16 before the max, which is exact on the rounded values,
  the incoming gradient is rounded to bfloat16, and dx is summed in float32
  and rounded once (``models/layers.py: aggregate_max`` and the kernels).
* ``gcn_both``: ``D_in^-1/2 A D_out^-1/2 x``, degrees counted with the
  self-loops and clamped at 1.
* Activations after each layer: leaky_relu (slope ``leaky_slope``, 0.01),
  relu or sigmoid.
* Loss: the weighted multi-label BCE of the source's ``multi_loss``, per
  fold over its training rows; each fold's gradient is its own.
* Adam (lr, betas, eps of the configuration; eps outside the square root,
  no weight decay), written out.

Everything else runs in float32 with TF32 off.  The aggregations walk the
edges in blocks, so the (edges, K) temporaries stay bounded.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import math
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import torch
import torch.nn.functional as F

# Elements of an (edges, K) temporary of an aggregation.
BLOCK = 1 << 26

# Where ``load_kind`` looks for ``<kind>.py``, in order.
KIND_DIRS = [Path(__file__).resolve().parent.parent / "kinds"]

# A configuration's ``agg_dtype``: the dtype of the aggregations' messages.
AGG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_kind(kind: str) -> ModuleType:
    """The module of layer kind ``kind``: the first ``<kind>.py`` in
    ``KIND_DIRS``."""
    for base in KIND_DIRS:
        path = Path(base) / f"{kind}.py"
        if path.is_file():
            return _load_module(str(path))
    raise ValueError(f"unknown layer kind {kind!r}: no {kind}.py in "
                     f"{[str(d) for d in KIND_DIRS]}")


@functools.lru_cache(maxsize=None)
def _load_module(path: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"gpubench_kind_{Path(path).stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def agg_dtype(config: dict) -> torch.dtype:
    """The configuration's message dtype (``agg_dtype``, float32 by default)."""
    return AGG_DTYPES[config.get("agg_dtype", "float32")]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass
class PlainGraph:
    """Edges sorted by (dst, src), self-loops included where asked."""

    src: torch.Tensor        # (E,) int64
    dst: torch.Tensor
    n: int
    in_deg: torch.Tensor     # (n,) float32, clamped at 1
    out_deg: torch.Tensor

    @classmethod
    def build(cls, src: torch.Tensor, dst: torch.Tensor, n: int,
              self_loops: bool) -> "PlainGraph":
        if self_loops:
            loops = torch.arange(n, device=src.device)
            src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
        order = torch.argsort(dst * n + src)
        src, dst = src[order], dst[order]

        def deg(ix):
            return torch.bincount(ix, minlength=n).clamp(min=1).float()

        return cls(src=src, dst=dst, n=n, in_deg=deg(dst), out_deg=deg(src))

    def blocks(self, k: int):
        step = max(BLOCK // max(k, 1), 1)
        for e0 in range(0, self.src.numel(), step):
            e1 = min(e0 + step, self.src.numel())
            yield e0, e1, self.src[e0:e1], self.dst[e0:e1]


class _FirstMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, graph: PlainGraph) -> torch.Tensor:
        n, k = x.shape
        e = graph.src.numel()
        out = torch.full((n, k), -math.inf, device=x.device)
        for _, _, s, d in graph.blocks(k):
            out.scatter_reduce_(0, d[:, None].expand(-1, k), x[s], "amax")
        # the first maximum: the lowest edge position holding the row's max
        first = torch.full((n, k), e, dtype=torch.int64, device=x.device)
        for e0, e1, s, d in graph.blocks(k):
            pos = torch.arange(e0, e1, device=x.device)[:, None]
            cand = torch.where(x[s] == out[d], pos, e)
            first.scatter_reduce_(0, d[:, None].expand(-1, k), cand, "amin")
        out = torch.where(first < e, out, 0.0)
        ctx.graph = graph
        ctx.save_for_backward(first)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (first,) = ctx.saved_tensors
        graph = ctx.graph
        n, k = g.shape
        e = graph.src.numel()
        dx = torch.zeros((n, k), device=g.device)
        cols = torch.arange(k, device=g.device)
        step = max(BLOCK // max(k, 1), 1)
        for r0 in range(0, n, step):
            f = first[r0:r0 + step]
            hit = f < e
            to = graph.src[f.clamp(max=e - 1)] * k + cols
            dx.view(-1).index_add_(0, to[hit], g[r0:r0 + step][hit])
        return dx, None


class _Round(torch.autograd.Function):
    """x rounded to ``dtype`` and back to float32; the gradient likewise."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ctx.dtype = dtype
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.to(ctx.dtype).float(), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, graph: PlainGraph) -> torch.Tensor:
        out = torch.zeros_like(x)
        for _, _, s, d in graph.blocks(x.shape[1]):
            out.index_add_(0, d, x[s])
        ctx.graph = graph
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dx = torch.zeros_like(g)
        for _, _, s, d in ctx.graph.blocks(g.shape[1]):
            dx.index_add_(0, s, g[d])
        return dx, None


def first_max(graph: PlainGraph, x: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The maximum over in-edges with ``dtype`` messages: rounded to it on
    the way in (the max is exact on them) and the gradient rounded to it on
    the way back in and out (dx summed in float32, then rounded once)."""
    if dtype == torch.float32:
        return _FirstMax.apply(x.contiguous(), graph)
    m = _FirstMax.apply(_Round.apply(x, dtype).contiguous(), graph)
    return _Round.apply(m, dtype)


def gcn_both(graph: PlainGraph, x: torch.Tensor) -> torch.Tensor:
    h = x * graph.out_deg.rsqrt()[:, None]
    return _Sum.apply(h.contiguous(), graph) * graph.in_deg.rsqrt()[:, None]


def forward(config: dict, graph: PlainGraph, x: torch.Tensor,
            p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One fold's probabilities (n, C): each layer's kind, then its
    activation."""
    h = x
    for layer in config["layers"]:
        name = layer["name"]
        leaves = {k[len(name) + 1:]: v for k, v in p.items() if k.startswith(name + ".")}
        h = load_kind(layer["kind"]).forward(layer, config, graph, h, leaves)
        act = layer["act"]
        if act == "leaky_relu":
            h = F.leaky_relu(h, config.get("leaky_slope", 0.01))
        elif act == "relu":
            h = torch.relu(h)
        elif act == "sigmoid":
            h = torch.sigmoid(h)
        else:
            raise ValueError(f"unknown activation {act!r}")
    return h


def class_weights(labels: torch.Tensor) -> torch.Tensor:
    """``w_c = (n_labelled - n_c) / n_c`` (the source's weight_cal), float64."""
    lab = labels.double()
    n_c = lab.sum(0)
    n_lab = (lab.sum(1) > 0).sum()
    return (n_lab - n_c) / n_c


def bce(p: torch.Tensor, y: torch.Tensor, rows: torch.Tensor,
        w: torch.Tensor) -> torch.Tensor:
    """The source's multi_loss over the rows ``rows`` (bool (n,))."""
    p, y = p[rows], y[rows]
    ll = (y * torch.log(p.clamp(1e-9, 10.0)) * w
          + (1.0 - y) * torch.log((1.0 - p).clamp(1e-9, 10.0))) / (w + 1.0) * 2.0
    return -(ll.sum(0) / max(int(rows.sum()), 1)).sum()


@dataclasses.dataclass
class Steps:
    probs: List[torch.Tensor]        # per step: (B, n, C), before that step's update
    loss: List[torch.Tensor]         # per step: (B,) training loss
    grad1: Dict[str, torch.Tensor]   # the first step's gradient, (B, ...)
    theta: Dict[str, torch.Tensor]   # the leaves after the last step, (B, ...)


def train_steps(config: dict, graph: PlainGraph, x: torch.Tensor, labels: torch.Tensor,
                train_masks: torch.Tensor, weights: Dict[str, torch.Tensor],
                n_steps: int) -> Steps:
    """``n_steps`` training steps of every fold from ``weights``; results on
    the host.  ``x``, ``labels`` and the masks hold the real rows only."""
    no_tf32()
    w = class_weights(labels).float()
    lr, eps = config["lr"], config["eps"]
    b1, b2 = config["betas"]
    folds = train_masks.shape[0]
    probs = [[] for _ in range(n_steps)]
    loss = [[] for _ in range(n_steps)]
    grad1 = {k: [] for k in weights}
    theta = {k: [] for k in weights}
    for b in range(folds):
        p = {k: v[b].clone().requires_grad_(True) for k, v in weights.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        for t in range(1, n_steps + 1):
            out = forward(config, graph, x, p)
            lo = bce(out, labels, train_masks[b], w)
            grads = torch.autograd.grad(lo, list(p.values()))
            probs[t - 1].append(out.detach().cpu())
            loss[t - 1].append(lo.detach().cpu())
            with torch.no_grad():
                for (k, q), g in zip(p.items(), grads):
                    if t == 1:
                        grad1[k].append(g.cpu())
                    m[k] = b1 * m[k] + (1 - b1) * g
                    v2[k] = b2 * v2[k] + (1 - b2) * g * g
                    m_hat = m[k] / (1 - b1 ** t)
                    v_hat = v2[k] / (1 - b2 ** t)
                    q -= lr * m_hat / (v_hat.sqrt() + eps)
            del out, lo, grads
        for k, q in p.items():
            theta[k].append(q.detach().cpu())
    return Steps(probs=[torch.stack(s) for s in probs], loss=[torch.stack(s) for s in loss],
                 grad1={k: torch.stack(v) for k, v in grad1.items()},
                 theta={k: torch.stack(v) for k, v in theta.items()})
