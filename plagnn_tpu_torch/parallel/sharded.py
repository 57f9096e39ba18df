"""The multi-device training path: mesh, halo exchange, sharded layers and
the sharded fold runner, over ``torch.distributed``.

Port of ``plagnn_tpu/parallel/sharded.py``.  The JAX package runs one
``shard_map`` program over a ('fold', 'graph') device mesh; the port runs
one process per rank (``parallel/launch.py``, or ``torchrun``):

* 'graph': P ranks split the graph by destination blocks
  (``partition.py``) and exchange halo rows all-to-all once per layer;
* 'fold':  F groups of P ranks each train B/F folds of the fold batch.

Rank r sits at (fold r // P, graph r % P), as JAX's device reshape puts it.
Within a graph group the masked-BCE sums and the gradients are
``all_reduce``d and Adam runs replicated; the probabilities are
``all_gather``ed, so the threshold, the metrics and the sampled AUC run on
the global array: the epoch is the single-device runner's
(``train/runner.py``), given these collectives.  One
fold-batched path stands for both JAX steps (``_sharded_xla_step`` and
``_sharded_pallas_step``), as the single-device runner stands for both JAX
runners; each rank aggregates through the port's kernels
(``ops/spmm_kernels.py``): the max forward with ``empty_value=-inf`` for the
interior and boundary partial maxima.  With a hub cache
(``TrainConfig.hub_cache``) the rank's interior graph carries its hub tables
(``PartitionedGraph.shard``), so the interior pass, forward and autograd
backward, launches the hub instantiations of the max kernels (on a graph
axis of size 1, the local pass over all of the shard's edges); the boundary
pass never does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.spmm_kernels import spmm_max, spmm_sum
from ..train.runner import make_fold_runner
from .partition import PartitionedGraph, Shard, shard_features

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (fold, graph) grid and its two groups:
    ``graph_group`` (the P ranks that share its folds) and ``fold_group``
    (the F ranks that hold its graph shard)."""

    n_fold: int
    n_graph: int
    rank: int
    graph_group: Optional[dist.ProcessGroup]
    fold_group: Optional[dist.ProcessGroup]

    @property
    def fold_index(self) -> int:
        return self.rank // self.n_graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.n_graph

    def fold_slice(self, n_folds: int) -> slice:
        """This rank's folds of a batch of ``n_folds`` (a multiple of F)."""
        if n_folds % self.n_fold:
            raise ValueError(f"fold batch {n_folds} must be a multiple of the "
                             f"mesh fold axis {self.n_fold}")
        b = n_folds // self.n_fold
        return slice(self.fold_index * b, (self.fold_index + 1) * b)


def make_mesh(n_graph: int, n_fold: int = 1) -> Mesh:
    """The (fold, graph) mesh over the initialised world of F*P ranks.

    Every rank creates every graph group and then every fold group, in the
    same order (``new_group`` is collective: groups made out of order
    deadlock)."""
    world = dist.get_world_size()
    if world != n_graph * n_fold:
        raise ValueError(f"mesh fold={n_fold},graph={n_graph} needs "
                         f"{n_graph * n_fold} ranks, the world has {world}")
    rank = dist.get_rank()
    graph_group = fold_group = None
    for f in range(n_fold):
        ranks = [f * n_graph + g for g in range(n_graph)]
        grp = dist.new_group(ranks)
        if rank in ranks:
            graph_group = grp
    for g in range(n_graph):
        ranks = [f * n_graph + g for f in range(n_fold)]
        grp = dist.new_group(ranks)
        if rank in ranks:
            fold_group = grp
    return Mesh(n_fold=n_fold, n_graph=n_graph, rank=rank,
                graph_group=graph_group, fold_group=fold_group)


# ---------------------------------------------------------------------------
# Halo exchange.
# ---------------------------------------------------------------------------


class PendingExchange:
    """The handle of an exchange issued with ``async_op``: ``wait()`` before
    the halo is read.  Keeps the send buffer alive until then."""

    def __init__(self):
        self.work = None
        self.buffers = ()

    def wait(self):
        if self.work is not None:
            self.work.wait()
        self.work, self.buffers = None, ()


class HaloExchange(torch.autograd.Function):
    """Forward: the (P, S, K) send buffer (row ``send_idx[q, k]`` of x_own
    in slot (q, k), zeros at -1), ``all_to_all_single`` over the graph
    group; returns (P*S, K), slot (q, k) the k-th row asked of peer q
    (JAX ``sharded.py:42-63``).  Backward: the reverse ``all_to_all_single``
    of the gradient, then one ``index_add_`` per peer in ascending peer
    order into a float32 dx, rounded to x's dtype once.  A row goes at most
    once to each peer (the -1 slots add zeros), so dx is bit-identical run
    to run."""

    @staticmethod
    def forward(ctx, x_own, send_idx, group, pending):
        p, s = send_idx.shape
        x2 = x_own.reshape(x_own.shape[0], -1)
        valid = (send_idx >= 0)[..., None]
        buf = torch.where(valid, x2[send_idx.clamp(min=0).long()],
                          torch.zeros((), dtype=x2.dtype, device=x2.device))
        buf = buf.reshape(p * s, -1).contiguous()
        # the output is the received tensor itself, not a view of it: gloo
        # fills a CUDA tensor with an in-place copy at wait(), which autograd
        # forbids on a view made inside a custom Function
        recv = torch.empty((p * s, *x_own.shape[1:]), dtype=x_own.dtype,
                           device=x_own.device)
        work = dist.all_to_all_single(recv.view(p * s, -1), buf, group=group,
                                      async_op=pending is not None)
        if pending is not None:
            pending.work, pending.buffers = work, (buf, recv)
        ctx.save_for_backward(send_idx)
        ctx.group = group
        ctx.x_shape = x_own.shape
        return recv

    @staticmethod
    def backward(ctx, g):
        (send_idx,) = ctx.saved_tensors
        p, s = send_idx.shape
        g2 = g.reshape(p * s, -1).contiguous()
        back = torch.empty_like(g2)
        dist.all_to_all_single(back, g2, group=ctx.group)
        back = back.view(p, s, -1).float()
        valid = (send_idx >= 0)[..., None]
        idx = send_idx.clamp(min=0).long()
        dx = torch.zeros((ctx.x_shape[0], back.shape[-1]), dtype=torch.float32,
                         device=g.device)
        for q in range(p):
            dx.index_add_(0, idx[q], torch.where(valid[q], back[q], 0.0))
        return dx.to(g.dtype).reshape(ctx.x_shape), None, None, None


def halo_exchange(x_own: torch.Tensor, send_idx_p: torch.Tensor, group,
                  pending: Optional[PendingExchange] = None) -> torch.Tensor:
    """x_own (C, ...) -> halo (P*S, ...), differentiable; with ``pending``
    the exchange is issued asynchronously: call ``pending.wait()`` before
    reading the halo."""
    return HaloExchange.apply(x_own, send_idx_p, group, pending)


def gather_space(x_own: torch.Tensor, halo: torch.Tensor, n_pad: int) -> torch.Tensor:
    """The local gather space [own | halo | zero padding] of n_pad rows."""
    c, h = x_own.shape[0], halo.shape[0]
    z = torch.zeros((n_pad - c - h, *x_own.shape[1:]), dtype=x_own.dtype,
                    device=x_own.device)
    return torch.cat([x_own, halo, z])


def _padded(x_own: torch.Tensor, n_pad: int) -> torch.Tensor:
    """[own | zeros]: the interior pass's input (no halo needed)."""
    z = torch.zeros((n_pad - x_own.shape[0], *x_own.shape[1:]), dtype=x_own.dtype,
                    device=x_own.device)
    return torch.cat([x_own, z])


# ---------------------------------------------------------------------------
# Sharded aggregations (the models' aggregation hooks on one rank's shard).
# ---------------------------------------------------------------------------


def _sharded_pass(shard: Shard, mesh: Mesh, x_own: torch.Tensor, local, partial,
                  combine) -> torch.Tensor:
    """One aggregation over a rank's shard, on the messages of its own rows
    (C, ...).  A graph axis of size 1: the ``local`` pass over the interior
    graph (all of the shard's edges), no exchange.  Otherwise the exchange
    is issued asynchronously, the interior ``partial`` pass (over [own |
    0]) runs meanwhile, then the boundary pass over the gather space, and
    ``combine`` joins the two."""
    c, n_pad = shard.own_rows, shard.n_nodes
    if mesh.n_graph == 1:
        return local(shard.interior, _padded(x_own, n_pad))[:c]
    pending = PendingExchange()
    halo = halo_exchange(x_own, shard.send_idx, mesh.graph_group, pending)
    m_int = partial(shard.interior, _padded(x_own, n_pad))[:c]
    pending.wait()
    m_bnd = partial(shard.boundary, gather_space(x_own, halo, n_pad))[:c]
    return combine(m_int, m_bnd)


def _max_combine(m_int, m_bnd):
    m = torch.maximum(m_int, m_bnd)
    return m.masked_fill(torch.isneginf(m), 0.0)


class ShardedMaxAgg:
    """Max aggregation over one rank's shard: the counterpart of
    ``make_sharded_pallas_agg`` (JAX ``sharded.py:208-258``) under the -inf
    rule of ``sharded_sage_conv`` (``:136-142``): the interior and boundary
    passes ``spmm_max(..., empty_value=-inf)``, their elementwise maximum,
    and -inf -> 0 (a row with no edge at all; the interior holds the
    self-loop, so none on the training path).  A graph axis of size 1 runs
    the single local pass (``:236-241``).  The interior (or local) pass
    takes the shard's hub where its interior graph carries one
    (``spmm_max`` saves that graph for the backward, whose transpose hub
    the backward kernel then reads), the boundary pass none, as the JAX
    package's ``pallas_interior`` / ``pallas_boundary``.  Messages arrive in
    the aggregation dtype (``models/layers.py: aggregate_max`` casts first),
    so a bf16 run exchanges bf16 halos."""

    def __init__(self, shard: Shard, mesh: Mesh):
        self.shard, self.mesh = shard, mesh

    def __call__(self, x_own: torch.Tensor) -> torch.Tensor:
        return _sharded_pass(
            self.shard, self.mesh, x_own, spmm_max,
            lambda g, x: spmm_max(g, x, empty_value=-np.inf), _max_combine)


class ShardedSumAgg:
    """Sum aggregation over one rank's shard: interior + boundary passes of
    the port's sum kernel."""

    def __init__(self, shard: Shard, mesh: Mesh):
        self.shard, self.mesh = shard, mesh

    def __call__(self, x_own: torch.Tensor) -> torch.Tensor:
        return _sharded_pass(self.shard, self.mesh, x_own, spmm_sum, spmm_sum,
                             torch.add)


def sharded_sage_conv(params, shard: Shard, mesh: Mesh, x_own: torch.Tensor,
                      aggregator: str = "pool") -> torch.Tensor:
    """One fold's SAGEConv on a shard (JAX ``sharded_sage_conv``): params a
    mapping of (in, out) weights, x_own (C, F_in)."""
    if aggregator == "pool":
        pooled = torch.relu(x_own @ params["w_pool"] + params["b_pool"])
        m = ShardedMaxAgg(shard, mesh)(pooled)
    elif aggregator == "sum":
        m = ShardedSumAgg(shard, mesh)(x_own)
    else:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    return x_own @ params["w_self"] + m @ params["w_neigh"] + params["bias"]


def sharded_gcn_propagate(shard: Shard, mesh: Mesh, x_own: torch.Tensor,
                          norm: str = "both") -> torch.Tensor:
    """Degree-normalised propagation on a shard with the GLOBAL degrees of
    the own rows (JAX ``sharded.py:170-188``)."""
    if norm not in ("both", "left", "right", "none"):
        raise ValueError(f"unknown norm {norm!r}")

    def per_row(deg):
        return deg.clamp(min=1).to(x_own.dtype).reshape(-1, *([1] * (x_own.dim() - 1)))

    if norm == "both":
        x_own = x_own * torch.rsqrt(per_row(shard.out_degree))
    elif norm == "left":
        x_own = x_own / per_row(shard.out_degree)
    s = ShardedSumAgg(shard, mesh)(x_own)
    if norm == "both":
        s = s * torch.rsqrt(per_row(shard.in_degree))
    elif norm == "right":
        s = s / per_row(shard.in_degree)
    return s


def make_sharded_forward(mesh: Mesh, shard: Shard):
    """fwd(model, x_own) -> the fold-batched model's output on this rank's
    own rows (C, B, classes): the model runs unchanged, its max aggregation
    hooked to ``ShardedMaxAgg``."""
    agg = ShardedMaxAgg(shard, mesh)
    return lambda model, x_own: model(agg, x_own)


# ---------------------------------------------------------------------------
# The sharded fold runner.
# ---------------------------------------------------------------------------


def _all_gather_cat(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    if size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def make_sharded_fold_runner(mesh: Mesh, pgraph: PartitionedGraph, shard: Shard,
                             feats, labels, class_weight, cfg, device):
    """The fold-batched runner over the mesh, with the contract of
    ``train.engine.make_batched_fold_runner``:

    run(model, opt, train_masks (B, N_any), val_masks (B, N_any), alpha,
    n_epochs, epoch_offset, total_epochs, last_auc) -> (model, opt, last
    probs (B, n_real, C), history, epoch_ms).

    ``model`` holds this rank's B/F folds (``mesh.fold_slice``) and Adam
    steps them; masks arrive for all B folds in node order (>= n_real
    columns) and ``last_auc`` for all B folds.  The probabilities and the
    history come back for all B folds, in node order, on every rank (the
    fold groups gather them).  feats/labels: (n_real, F) / (n_real, C)
    host arrays."""
    n_real = pgraph.n_real_nodes
    c = pgraph.own_rows
    gi, p = mesh.graph_index, mesh.n_graph
    agg = ShardedMaxAgg(shard, mesh)

    feats = np.asarray(feats, np.float32)[:n_real]
    labels = np.asarray(labels, np.float32)[:n_real]
    x_own = torch.from_numpy(shard_features(feats, pgraph)[gi]).to(device)
    y_own = torch.from_numpy(shard_features(labels, pgraph)[gi]).to(device)
    # node of each own row (-1: padding) and row of each node
    if pgraph.row_map is not None:
        own_nodes = pgraph.row_map[gi * c:(gi + 1) * c].astype(np.int64)
        node_row = pgraph.node_row.astype(np.int64)
    else:
        own_nodes = np.arange(gi * c, (gi + 1) * c)
        own_nodes = np.where(own_nodes < n_real, own_nodes, -1)
        node_row = np.arange(n_real)
    own_valid = torch.from_numpy(own_nodes >= 0).to(device)
    own_nodes = torch.from_numpy(np.maximum(own_nodes, 0)).to(device)
    node_row = torch.from_numpy(node_row).to(device)

    def all_reduce(t):
        dist.all_reduce(t, group=mesh.graph_group)

    def gather_rows(probs_own):
        return _all_gather_cat(probs_own, mesh.graph_group, p, dim=1)[:, node_row]

    def gather_folds(t):
        return _all_gather_cat(t, mesh.fold_group, mesh.n_fold, dim=0)

    return make_fold_runner(
        lambda model: model(agg, x_own), torch.from_numpy(labels).to(device),
        class_weight, torch.ones(n_real, dtype=torch.bool, device=device), cfg,
        local_labels=y_own, local_masks=lambda m: m[:, own_nodes] & own_valid,
        all_reduce=all_reduce if p > 1 else None, gather_rows=gather_rows,
        fold_slice=mesh.fold_slice, gather_folds=gather_folds)


def gather_fold_state(mesh: Mesh, model: torch.nn.Module, opt: torch.optim.Adam):
    """(state_dict, Adam's per-parameter state) of the whole fold batch:
    every fold group's slice gathered over the fold groups, on every rank,
    for ``train.checkpoint.save_state_dicts``."""
    def cat(t):
        return _all_gather_cat(t.detach(), mesh.fold_group, mesh.n_fold, dim=0)

    model_state = {k: cat(v) for k, v in model.state_dict().items()}
    opt_state = {i: {"step": st["step"], "exp_avg": cat(st["exp_avg"]),
                     "exp_avg_sq": cat(st["exp_avg_sq"])}
                 for i, st in opt.state_dict()["state"].items()}
    return model_state, opt_state


def slice_fold_state(st: dict, folds: slice) -> dict:
    """A ``train.checkpoint.load_state`` result of the whole fold batch, cut
    to one rank's folds (for ``restore_state``)."""
    return {**st,
            "model": {k: v[folds] for k, v in st["model"].items()},
            "opt_state": {i: {"step": s["step"], "exp_avg": s["exp_avg"][folds],
                              "exp_avg_sq": s["exp_avg_sq"][folds]}
                          for i, s in st["opt_state"].items()}}
