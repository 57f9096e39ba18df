"""Training engine: the fold-batched GNN32, GCN2 or GAT ensemble.

Port of ``plagnn_tpu/train/engine.py`` (``TrainConfig``, the fold-batched
runner, ``train`` with mid-round checkpoints, ``_write_epoch_logs``,
``_write_tsv``).  The fold ensemble is a batch axis of the features
(N, B, F); the epoch itself is ``train/runner.py``'s.

Reference quirk kept for parity: the saved ``loc_logits.npy`` are the last
pre-update probabilities.  Artifact contract: ``{round}_{fold}_loc_logits.npy``,
``log.tsv``, ``txt_log.txt``, ``fig_data_{round}.json``.
"""
from __future__ import annotations

import csv
import dataclasses
import datetime
import json
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.batched import stack_folds
from ..models.gnn32 import MODEL_REGISTRY, ModelSpec
from ..ops.graph_format import Graph
from ..utils.precision import aggregation_dtype
from .checkpoint import (load_state, restore_state, round_complete, save_state,
                         save_state_dicts)
from .kfold import FOLD_SEEDS, fold_node_masks
from .losses import weight_cal
from .postprocess import protein_loc_correction_np
from .runner import make_adam, make_fold_runner


@dataclasses.dataclass
class TrainConfig:
    lr: float = 5e-5
    fold_num: int = 10
    epoch_num: int = 200
    alpha_list: Tuple[float, ...] = (0.1,)
    fold_seeds: Tuple[int, ...] = FOLD_SEEDS
    seed: int = 70
    fold_batch: int = 10          # folds trained together (batch axis width)
    model: str = "gnn32"          # a key of models.gnn32.MODEL_REGISTRY
    # GNN32 takes all four widths; GCN2 its first (the hidden width); GAT
    # one width a head for each layer before the output layer (256, 256)
    hidden: Tuple[int, ...] = (400, 300, 200, 100)
    num_classes: int = 12
    compute_auc: bool = True
    # AUC sampling cadence, on GLOBAL epoch indices; the final epoch is
    # always sampled and the value carries between samples.
    auc_every: int = 5
    log_every: int = 5
    verbose: bool = True
    resume: bool = True           # skip rounds whose artifacts already exist
    # Mid-round checkpoints: persist the chunk's model, Adam state and
    # history every N epochs (ckpt_a{alpha}_j{chunk}.npz, removed when the
    # chunk ends) and resume from it; 0 disables.
    # chunk_callback(round, alpha, chunk start, epochs done) fires after
    # every stretch of epochs (progress reporting, fault injection).
    checkpoint_every: int = 0
    chunk_callback: Optional[Callable[[int, float, int, int], None]] = None
    # The (fold, graph) mesh: mesh_graph ranks split the graph by
    # destination blocks (a halo exchange per layer), mesh_fold groups of
    # them train fold_batch / mesh_fold folds each; F*P > 1 needs that many
    # initialised ranks (parallel/launch.py, torchrun).  mesh_balance deals
    # nodes to the blocks by in-degree (parallel/partition.py).
    mesh_fold: int = 1
    mesh_graph: int = 1
    mesh_balance: bool = True
    # The hub cache of the aggregation kernels (ops/hub.py): "auto" (the
    # measured policy), "off", or k rows of each direction's arena.
    # Resolved at the run's worst aggregation width on one rank
    # (resolve_hub); on one device 0 past 2^15 padded nodes (as the JAX
    # package's engine), on a mesh each rank's interior pass takes it.
    hub_cache: str = "auto"


METRIC_KEYS = ("aim", "cov", "acc", "loss")


@dataclasses.dataclass
class ChunkStats:
    folds: int
    epoch_ms: List[float]   # wall time of each epoch (CUDA events on a card)


def resolve_device(device) -> torch.device:
    """The torch device for a run; a CUDA device with no card raises (the
    port never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass -d cpu to run on the CPU")
    return dev


def fold_seed(seed: int, round_idx: int, fold: int, alpha_idx: int) -> int:
    """Init seed of one fold job from (seed, round, fold, alpha): init is
    invariant to the fold-batch packing and to resume order."""
    ss = np.random.SeedSequence([seed, round_idx, fold, alpha_idx])
    return int(ss.generate_state(1, np.uint64)[0] & np.uint64(2**63 - 1))


def model_spec(cfg: TrainConfig) -> ModelSpec:
    """``cfg.model``'s registry entry, once it has not refused ``cfg``."""
    spec = MODEL_REGISTRY.get(cfg.model)
    if spec is None:
        raise ValueError(f"unknown model {cfg.model!r}; one of {sorted(MODEL_REGISTRY)}")
    if spec.refuse is not None:
        spec.refuse(cfg)
    return spec


def init_fold_model(cfg: TrainConfig, in_feats: int, seeds: Sequence[int],
                    device) -> torch.nn.Module:
    """Fold batch of freshly initialised ``cfg.model``s, one
    ``torch.Generator`` per fold."""
    spec = model_spec(cfg)
    widths = tuple(cfg.hidden) if spec.all_widths else (cfg.hidden[0],)
    models = [
        spec.init(torch.Generator().manual_seed(s), in_feats, *widths,
                  num_classes=cfg.num_classes, **spec.extra)
        for s in seeds
    ]
    return stack_folds(models).to(device)


def resolve_hub(cfg: TrainConfig, graph: Graph, in_feats: int,
                shard_rows: Optional[int] = None) -> Tuple[int, int]:
    """(k_fwd, k_bwd) of a run: ``pick_hub_sizes`` at its worst aggregation
    width on one rank (the JAX engine's rule,
    ``plagnn_tpu/train/engine.py:527-535``, ``:573-581``): GNN32's max
    over (in_feats, h1, h2) in the aggregation dtype, GCN2's float32 sums
    over (min(in_feats, h), min(h, classes)), times the rank's fold batch
    ``fold_batch // mesh_fold`` (JAX's ``b_local``).

    On one device the backward's arena holds the graph's argmax, and no hub
    runs past 2^15 padded nodes (the JAX engine's guard: that graph is
    positional).  On a mesh the hub goes to each rank's interior pass, and
    ``shard_rows``, the rows of a shard's gather space
    (``PartitionedGraph.n_pad``), sizes the max backward's arena: the
    shards are id-based at any size, so no guard applies, and past 2^15
    rows their argmax is int32 (``spmm_kernels.argmax_bytes``).  GCN2's
    sums hold no argmax in either direction's arena.  GAT's "auto" and
    "off" take none, and its entry refuses an explicit size
    (``models/gnn32.py: refuse_gat``)."""
    from ..ops.hub import pick_hub_sizes
    from ..ops.spmm_kernels import argmax_bytes

    mesh = cfg.mesh_fold * cfg.mesh_graph > 1
    if mesh and shard_rows is None:
        raise ValueError("a mesh run's hub is sized on its shards: pass shard_rows "
                         "(PartitionedGraph.n_pad)")
    if cfg.model == "gcn2":
        h = cfg.hidden[0]
        widths, esize, arg_size = (min(in_feats, h), min(h, cfg.num_classes)), 4, 0
    else:
        widths = (in_feats, *cfg.hidden[:2])
        esize = 2 if aggregation_dtype() is not None else 4
        arg_size = argmax_bytes(shard_rows if mesh else graph.n_nodes)
    kf, kb = pick_hub_sizes(cfg.hub_cache, cfg.fold_batch // cfg.mesh_fold * max(widths),
                            esize, arg_size)
    if not mesh and graph.n_nodes > (1 << 15):
        kf = kb = 0
    return kf, kb


def make_batched_fold_runner(graph: Graph, feats: torch.Tensor,
                             labels: torch.Tensor, class_weight,
                             node_valid: torch.Tensor, cfg: TrainConfig):
    """Fold-batched runner over tensors already on the run's device
    (``train.runner.make_fold_runner`` on the whole graph).

    Returns run(model, opt, train_masks (B, N), val_masks (B, N), alpha,
    n_epochs, epoch_offset, total_epochs, last_auc) -> (model, opt,
    last_probs (B, N, C), history, epoch_ms), history a dict of numpy (B, E)
    arrays plus pred_num (B, E, C) int32, as the JAX runner returns them.
    ``last_auc`` carries the sampled AUC pair into a later stretch of epochs
    (default 0.5 each)."""
    return make_fold_runner(lambda model: model(graph, feats), labels, class_weight,
                            node_valid, cfg)


_TPLT = (
    "{:.2f}%({:<6})\t{:.2f}%({:<6})\t{:.2f}%({:<6})\t{:.2f}%({:<6})\t"
    "{:.2f}%({:<6})\t{:.2f}%({:<6})\t{:.2f}%({:<6})\t{:.2f}%({:<6})\t"
    "{:.2f}%({:<6})\t{:.2f}%({:<6})\t{:.2f}%({:<6})\t{:.2f}%({:<6})\n"
)


def _fmt_counts(scale, num):
    args = []
    for s, c in zip(scale, num):
        args.extend([float(s), int(c)])
    return _TPLT.format(*args)


def _res_mapping(row: np.ndarray) -> str:
    """1-based comma-joined label indices."""
    idx = np.where(row == 1)[0] + 1
    return ", ".join(str(i) for i in idx)


def train(
    graph: Graph,
    feats,
    labels,
    label_indices: Sequence[int],
    loc_mat_full: np.ndarray,
    cfg: TrainConfig,
    path: str,
    label_names: Optional[Sequence[str]] = None,
    device_name: str = "cuda",
) -> List[ChunkStats]:
    """Full-ensemble training loop (the reference's train.py contract).

    graph/feats/labels come from ``data.artifacts.load_condition`` (host);
    ``device_name`` is the torch device (default ``cuda``) and the device
    label written to txt_log.txt.  Returns per-chunk epoch timings.

    With ``cfg.mesh_fold * cfg.mesh_graph > 1`` every rank of the
    initialised process group calls this with its own device: the graph is
    partitioned, each rank trains its fold group's folds on its shard
    through the sharded runner, and rank 0 alone writes the artifacts and
    the checkpoints (a barrier after each write)."""
    device = resolve_device(device_name)
    model_spec(cfg)               # refuses before any work, a mesh's included
    os.makedirs(path, exist_ok=True)
    in_feats = feats.shape[1]
    class_weight = weight_cal(loc_mat_full)
    n_real = graph.n_real_nodes
    mesh = None
    if cfg.mesh_fold * cfg.mesh_graph > 1:
        mesh, run, hub_k = _mesh_runner(graph, feats, labels, class_weight, cfg,
                                        device)
    else:
        hub_k = resolve_hub(cfg, graph, in_feats)
        feats_t = torch.as_tensor(np.asarray(feats, np.float32), device=device)
        labels_t = torch.as_tensor(np.asarray(labels, np.float32), device=device)
        node_valid = torch.arange(graph.n_nodes, device=device) < n_real
        run_graph = graph.with_hub(*hub_k) if any(hub_k) else graph
        run = make_batched_fold_runner(run_graph.to(device), feats_t, labels_t,
                                       class_weight, node_valid, cfg)
    is_main = mesh is None or mesh.rank == 0
    verbose = cfg.verbose and is_main
    if verbose:
        print(f"hub cache: k_fwd={hub_k[0]} k_bwd={hub_k[1]} (hub_cache={cfg.hub_cache!r})")

    labels_np = np.asarray(labels)[:n_real]
    p_label_num = labels_np.astype(int).sum(0)
    p_label_scale = p_label_num / len(label_indices) * 100

    log_write_flag = True
    tsv_path = os.path.join(path, "log.tsv")
    txt_path = os.path.join(path, "txt_log.txt")

    # Cross-round fold batching: the work queue flattens (round, fold) and
    # chunks by fold_batch, so a wide fold batch packs folds of several rounds.
    rounds_todo = []
    for round_idx, fseed in enumerate(cfg.fold_seeds, start=1):
        if cfg.resume and round_complete(path, round_idx, cfg.fold_num):
            if verbose:
                print(f"[round {round_idx}] artifacts complete, skipping (resume)")
            continue
        tr_np, va_np = fold_node_masks(
            label_indices, graph.n_nodes, cfg.fold_num, fseed)
        rounds_todo.append((round_idx, tr_np, va_np))

    fig_acc = {r[0]: {"train": {}, "validation": {}} for r in rounds_todo}
    done_cnt = {r[0]: 0 for r in rounds_todo}
    per_round_total = len(cfg.alpha_list) * cfg.fold_num
    stats: List[ChunkStats] = []

    def _flush_round(round_idx):
        fig_data = fig_acc.pop(round_idx)
        with open(os.path.join(path, f"fig_data_{round_idx}.json"), "w") as f:
            json.dump(fig_data, f)
        if verbose:
            val_d = fig_data["validation"][cfg.alpha_list[0]]
            last = {k: float(np.mean([v[k][-1] for v in val_d.values()]))
                    for k in METRIC_KEYS}
            print(
                f"[round {round_idx}/{len(cfg.fold_seeds)}] "
                + ", ".join(f"val {k}={v:.3f}" for k, v in last.items())
            )

    ck_every = int(cfg.checkpoint_every or 0)
    ck_cfg = _checkpoint_fingerprint(cfg)
    for a_i, alpha in enumerate(cfg.alpha_list):
        jobs = [
            (round_idx, f + 1, tr_np[f], va_np[f])
            for round_idx, tr_np, va_np in rounds_todo
            for f in range(cfg.fold_num)
        ]
        for c0 in range(0, len(jobs), cfg.fold_batch):
            chunk = jobs[c0:c0 + cfg.fold_batch]
            # a mesh shards the fold batch over its fold axis: a partial last
            # chunk is padded to a multiple of it by repeating jobs, whose
            # outputs are never written (JAX engine.py:656-661)
            nb = len(chunk)
            pad_n = (-nb) % cfg.mesh_fold if mesh is not None else 0
            run_chunk = chunk + [chunk[i % nb] for i in range(pad_n)]
            seeds = [fold_seed(cfg.seed, r_i, f_f, a_i) for r_i, f_f, _, _ in run_chunk]
            # a mesh rank initialises its fold group's folds only: each fold
            # has its own generator, so they equal the whole chunk's slice
            mine = mesh.fold_slice(len(run_chunk)) if mesh is not None else slice(None)
            model = init_fold_model(cfg, in_feats, seeds[mine], device)
            opt = make_adam(model, cfg)
            tr_masks = torch.as_tensor(np.stack([j[2] for j in run_chunk]), device=device)
            va_masks = torch.as_tensor(np.stack([j[3] for j in run_chunk]), device=device)

            # Stretches of checkpoint_every epochs with a checkpoint after
            # each: a crash loses at most that many epochs of this chunk.
            ck_file = os.path.join(path, f"ckpt_a{a_i}_j{c0}.npz")
            done = 0
            history = None
            if ck_every and cfg.resume and os.path.exists(ck_file):
                st = load_state(ck_file)
                _check_checkpoint_config(ck_file, st["config"], ck_cfg)
                if mesh is not None:
                    from ..parallel.sharded import slice_fold_state

                    st = slice_fold_state(st, mine)
                restore_state(st, model, opt)
                done = int(st["epochs_done"])
                history = st["history"]
                if verbose:
                    print(f"[alpha {alpha}] resume job chunk {c0}.. at epoch {done}")
            epoch_ms: List[float] = []
            while done < cfg.epoch_num:
                n_run = min(ck_every, cfg.epoch_num - done) if ck_every else cfg.epoch_num
                model, opt, f_probs, hist, ms = run(
                    model, opt, tr_masks, va_masks, float(alpha),
                    n_epochs=n_run, epoch_offset=done, total_epochs=cfg.epoch_num,
                    last_auc=_carried_auc(history, cfg, device))
                history = hist if history is None else _concat_history(history, hist)
                epoch_ms += ms
                done += n_run
                if ck_every and done < cfg.epoch_num:
                    _save_checkpoint(ck_file, mesh, model, opt, done, history, ck_cfg)
                if cfg.chunk_callback is not None:
                    cfg.chunk_callback(chunk[0][0], alpha, c0, done)
            stats.append(ChunkStats(folds=len(chunk), epoch_ms=epoch_ms))
            f_probs = f_probs.cpu().numpy()
            if not is_main:
                _barrier(mesh)      # rank 0 writes this chunk's artifacts
                continue
            if ck_every and os.path.exists(ck_file):
                os.remove(ck_file)

            for b, (round_idx, fold_flag, trm, vam) in enumerate(chunk):
                train_d = fig_acc[round_idx]["train"].setdefault(alpha, {})
                val_d = fig_acc[round_idx]["validation"].setdefault(alpha, {})
                train_d[fold_flag] = {
                    k: np.asarray(history["train"][k][b]).astype(float).tolist()
                    for k in METRIC_KEYS
                }
                val_d[fold_flag] = {
                    k: np.asarray(history["val"][k][b]).astype(float).tolist()
                    for k in METRIC_KEYS
                }
                if cfg.compute_auc:
                    for k in ("auc_micro", "auc_macro"):
                        val_d[fold_flag][k] = (
                            np.asarray(history["val"][k][b]).astype(float).tolist())
                for f1k in ("f1_micro", "f1_macro"):
                    val_d[fold_flag][f1k] = (
                        np.asarray(history["val"][f1k][b]).astype(float).tolist())
                # final-epoch per-organelle prediction counts
                val_d[fold_flag]["pred_num_final"] = [
                    int(v) for v in history["pred_num"][b, -1]
                ]

                logits_b = f_probs[b, :n_real]
                np.save(
                    os.path.join(path, f"{round_idx}_{fold_flag}_loc_logits"),
                    logits_b.astype(np.float32),
                )
                _write_epoch_logs(
                    txt_path, cfg, round_idx, fold_flag, alpha,
                    history, b, p_label_scale, p_label_num, device_name,
                    n_real,
                )
                log_write_flag = _write_tsv(
                    tsv_path, log_write_flag, round_idx, fold_flag, alpha,
                    logits_b, labels_np, trm, vam, label_names, n_real,
                    node_alpha=alpha,
                )
                done_cnt[round_idx] += 1
                if done_cnt[round_idx] == per_round_total:
                    _flush_round(round_idx)
            _barrier(mesh)
    return stats


def _mesh_runner(graph: Graph, feats, labels, class_weight, cfg: TrainConfig,
                 device):
    """(mesh, sharded runner, (k_fwd, k_bwd)) of a mesh run: the
    destination-block partition of the graph (its edges already hold the
    self-loops), the hub resolved on its shards, this rank's shard on its
    device (its interior with the hub) and the runner over it."""
    import torch.distributed as dist

    from ..parallel.partition import partition_graph
    from ..parallel.sharded import make_mesh, make_sharded_fold_runner

    n_mesh = cfg.mesh_fold * cfg.mesh_graph
    if cfg.fold_batch % cfg.mesh_fold:
        raise ValueError(f"fold_batch {cfg.fold_batch} must be a multiple of "
                         f"mesh_fold {cfg.mesh_fold}")
    if not dist.is_initialized() or dist.get_world_size() != n_mesh:
        raise RuntimeError(
            f"mesh fold={cfg.mesh_fold},graph={cfg.mesh_graph} needs a process "
            f"group of {n_mesh} ranks (parallel.launch.spawn_local or torchrun)")
    n_real = graph.n_real_nodes
    pgraph = partition_graph(
        graph.src.cpu().numpy(), graph.dst.cpu().numpy(), n_real, cfg.mesh_graph,
        balance=bool(cfg.mesh_balance) and cfg.mesh_graph > 1)
    hub_k = resolve_hub(cfg, graph, np.shape(feats)[1], pgraph.n_pad)
    mesh = make_mesh(cfg.mesh_graph, cfg.mesh_fold)
    shard = pgraph.shard(mesh.graph_index, device, *hub_k)
    run = make_sharded_fold_runner(
        mesh, pgraph, shard, np.asarray(feats)[:n_real], np.asarray(labels)[:n_real],
        class_weight, cfg, device)
    return mesh, run, hub_k


def _barrier(mesh) -> None:
    """All ranks wait for rank 0's writes (no-op on one device)."""
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()


def _save_checkpoint(ck_file: str, mesh, model, opt, done: int, history,
                     ck_cfg: dict) -> None:
    """The chunk's mid-round checkpoint; on a mesh the fold groups' states
    are gathered and rank 0 writes the whole fold batch's."""
    if mesh is None:
        save_state(ck_file, model, opt, done, history, ck_cfg)
        return
    from ..parallel.sharded import gather_fold_state

    model_state, opt_state = gather_fold_state(mesh, model, opt)
    if mesh.rank == 0:
        save_state_dicts(ck_file, model_state, opt_state, done, history, ck_cfg)
    _barrier(mesh)


def _carried_auc(history, cfg: TrainConfig, device):
    """The AUC pair the last stretch of epochs ended with, so the value
    carried between samples crosses a checkpoint as in an uninterrupted
    run; None (start at 0.5) for a chunk's first stretch."""
    if history is None or not cfg.compute_auc:
        return None
    return tuple(torch.as_tensor(history["val"][k][:, -1], device=device)
                 for k in ("auc_micro", "auc_macro"))


def _concat_history(a, b):
    """Two runner histories joined along the epoch axis."""
    if isinstance(a, dict):
        return {k: _concat_history(a[k], b[k]) for k in a}
    return np.concatenate([a, b], axis=1)


def _checkpoint_fingerprint(cfg: TrainConfig) -> dict:
    """Config fields a mid-round checkpoint depends on.

    The chunk files are keyed ``ckpt_a{a_i}_j{c0}.npz``: fold_batch changes
    the (round, fold) -> chunk mapping and the batch width of every saved
    tensor; epoch_num/alpha_list change the chunk offsets and job list;
    agg_dtype changes the numerical trajectory; seed/lr/fold_num/model/
    hidden and the model's fixed arguments (GAT's heads) change the
    parameters the state continues from.  Resuming across any of these
    would load mismatched state or silently diverge.  A mesh with a fold
    axis adds mesh_fold, which pads a partial last chunk.
    hub_cache is kept as the JAX package keeps it (its hub changes its add
    order); the port's hub kernels keep the add order, but a resume across
    it refuses all the same."""
    fp = {
        "fold_batch": int(cfg.fold_batch),
        "epoch_num": int(cfg.epoch_num),
        "alpha_list": tuple(float(a) for a in cfg.alpha_list),
        "fold_num": int(cfg.fold_num),
        "fold_seeds": tuple(int(s) for s in cfg.fold_seeds),
        "agg_dtype": "bfloat16" if aggregation_dtype() is not None else "float32",
        "seed": int(cfg.seed),
        "lr": float(cfg.lr),
        "model": str(cfg.model),
        "hidden": tuple(int(h) for h in cfg.hidden),
        "hub_cache": str(cfg.hub_cache),
    }
    if cfg.mesh_fold > 1:
        fp["mesh_fold"] = int(cfg.mesh_fold)
    for k, v in MODEL_REGISTRY[cfg.model].extra.items():
        fp[k] = tuple(int(h) for h in v)
    return fp


def _check_checkpoint_config(ck_file: str, saved: Optional[dict],
                             current: dict) -> None:
    if saved is None:
        raise ValueError(
            f"checkpoint {ck_file} predates config fingerprinting and cannot "
            "be verified against the current run configuration; delete it to "
            "restart this job chunk from epoch 0")
    diffs = {k: (saved.get(k), current[k]) for k in current
             if _norm(saved.get(k)) != _norm(current[k])}
    if diffs:
        detail = "; ".join(
            f"{k}: checkpoint={s!r} vs current={c!r}" for k, (s, c) in diffs.items())
        raise ValueError(
            f"checkpoint {ck_file} was written under a different run "
            f"configuration ({detail}); resuming would load mismatched state "
            "or silently diverge — rerun with the original flags, or delete "
            "the checkpoint to restart this job chunk from epoch 0")


def _norm(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _write_epoch_logs(
    txt_path, cfg, round_idx, fold_flag, alpha, history, b,
    p_label_scale, p_label_num, device_name, n_real,
):
    """The every-5-epochs console/txt channel, written from the metric
    history after the run."""
    with open(txt_path, "a") as f:
        for e in range(cfg.epoch_num):
            if not (e % cfg.log_every == 0 or e == cfg.epoch_num - 1):
                continue
            if cfg.verbose:
                time_s = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
                print(
                    "TIME: {}, In epoch {} / fold {} / round {}, learning rate: {:.10f}, alpha: {:.2f}".format(
                        time_s, e, fold_flag, round_idx, cfg.lr, alpha
                    )
                )
                print(
                    "tra -- aim: {:.3f}, cov: {:.3f}, acc: {:.3f}, loss: {:.8f}".format(
                        history["train"]["aim"][b, e], history["train"]["cov"][b, e],
                        history["train"]["acc"][b, e], history["train"]["loss"][b, e],
                    )
                )
                print(
                    "val -- aim: {:.3f}, cov: {:.3f}, acc: {:.3f}, loss: {:.8f}".format(
                        history["val"]["aim"][b, e], history["val"]["cov"][b, e],
                        history["val"]["acc"][b, e], history["val"]["loss"][b, e],
                    )
                )
            pred_num = history["pred_num"][b, e]
            # p_pred_scale over the full row count, as the reference
            pred_scale = pred_num / n_real * 100.0
            if e == 0:
                f.write("-" * 190 + "\n")
                f.write("-" * 190 + "\n")
                f.write(
                    "learning rate:{:.8f}, fold num:{}, epoch num:{}, alpha:{}, device:{}\n".format(
                        cfg.lr, fold_flag, cfg.epoch_num, alpha, device_name
                    )
                )
                f.write(_fmt_counts(p_label_scale, p_label_num))
            f.write(_fmt_counts(pred_scale, pred_num))


def _write_tsv(
    tsv_path, log_write_flag, round_idx, fold_flag, alpha,
    logits, labels_np, tr_mask, va_mask, label_names, n_real, node_alpha,
):
    """log.tsv (round, fold, flag-t0v1, index, true, pred) from the
    final-epoch predictions."""
    pred = protein_loc_correction_np(logits, node_alpha)
    mapped = {}   # _res_mapping by row bytes: few distinct rows, many nodes

    def mapping(row):
        key = (row.dtype.str, row.tobytes())
        if key not in mapped:
            mapped[key] = _res_mapping(row)
        return mapped[key]

    rows = []
    for flag, mask in ((0, tr_mask), (1, va_mask)):
        idxs = np.flatnonzero(mask[:n_real])
        for i in idxs:
            name = label_names[i] if label_names is not None else str(i)
            rows.append(
                [round_idx, fold_flag, flag, name,
                 mapping(labels_np[i]), mapping(pred[i])]
            )
    with open(tsv_path, "a+") as f:
        writer = csv.writer(f, delimiter="\t")
        if log_write_flag:
            writer.writerow(
                ["round", "fold", "flag-t0v1", "index", "true label", "predict label"]
            )
        writer.writerows(rows)
    return False
