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

On one CUDA device (no collective given) the epoch runs eagerly once, as
warm-up, and from then on as replays of CUDA graphs (``EpochGraphs``): the
same kernels in the same order on the same data, with no launch from
Python.  The CPU and the sharded runner stay eager.
"""
from __future__ import annotations

import contextlib
import inspect
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import spmm_kernels
from ..utils import profiling
from ..utils.precision import aggregation_dtype
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

# The pieces an epoch runs, in order: EPOCH_PHASES with the metrics phase
# split around the AUC ("losses" before it, "metrics" after it), so that an
# epoch off the AUC's cadence runs every piece but "auc".  Each is one CUDA
# graph, captured and replayed in this order.
PIECES = ("forward", "backward", "adam", "losses", "auc", "metrics")

Reduce = Callable[[torch.Tensor], None]          # in place
Gather = Callable[[torch.Tensor], torch.Tensor]


def make_adam(model: torch.nn.Module, cfg) -> torch.optim.Adam:
    """One Adam state over the fold-stacked parameters (optax.adam's
    update: eps outside the square root, no weight decay).  On CUDA
    parameters it is ``capturable``: the step count and the bias
    corrections stay on the device, so a CUDA graph can replay the step and
    the eager step does the same arithmetic (torch refuses it on the CPU).
    The span ``setup.optimizer_init`` holds the first call's import of
    ``torch._dynamo``."""
    with profiling.span("setup.optimizer_init"):
        params = list(model.parameters())
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                capturable=all(p.is_cuda for p in params))


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
        self.replayed: List[bool] = []
        if self.cuda:
            self.stream = torch.cuda.current_stream()
            self.free = EpochTimer._free_events.setdefault(self.stream.device_index, [])

    def start(self, replayed: bool = False):
        """A new epoch; ``replayed``: it replays CUDA graphs."""
        self.epochs.append([(None, self._mark())])
        self.replayed.append(replayed)

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
        row of EPOCH_PHASES -> ms to ``profiling.PHASES`` and whether it
        was replayed to ``profiling.EPOCH_REPLAYED``."""
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
        profiling.EPOCH_REPLAYED.extend(self.replayed)
        if self.cuda:
            self.free.extend(ev for marks in self.epochs for _, ev in marks)
        self.epochs, self.replayed = [], []
        return out


def graph_key(model: torch.nn.Module, opt: torch.optim.Optimizer, folds: int,
              pieces: Dict[str, Callable]) -> tuple:
    """What an epoch's CUDA graphs bake in: the parameters' storage, the
    fold count, Adam's hyperparameters and its ``step``, the matmul
    precision, the aggregation dtype, and what the pieces look up by global
    name (``looked_up``).  A change to any of them captures anew.  Code that
    the pieces reach through those objects (the model's layers, the helpers
    inside ``metrics.py``) is baked in as it stood at the capture: a patch
    there takes a new runner."""
    group = opt.param_groups[0]
    return (tuple(p.data_ptr() for p in model.parameters()), folds, group["lr"],
            tuple(group["betas"]), group["eps"], type(opt).step,
            torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
            aggregation_dtype(), looked_up(pieces))


def looked_up(pieces: Dict[str, Callable]) -> tuple:
    """(name, object) for every global that a piece names, as it stands now."""
    out = []
    for piece in pieces.values():
        fn = inspect.unwrap(piece)
        out.extend((n, fn.__globals__[n]) for n in fn.__code__.co_names if n in fn.__globals__)
    return tuple(out)


def has_state(opt: torch.optim.Optimizer, model: torch.nn.Module) -> bool:
    """Whether ``opt`` holds a state for every parameter (it has stepped)."""
    return all(opt.state.get(p) for p in model.parameters())


def release_warm_up(run_state: SimpleNamespace) -> List[int]:
    """Let go of what the eager epochs left in the card's cache, and return
    the sizes of the cache's large segments that were then free, which
    ``empty_cache`` has handed back to the card.

    The warm-up's gradients and probabilities go.  The cuBLAS workspaces and
    Adam's state were made in the warm-up's first GEMM and step, inside
    segments that the epoch's activations had freed: the workspaces are
    dropped (the next GEMM makes them anew) and Adam's state moves through
    the host, so that no small tensor keeps an epoch-sized segment."""
    torch.cuda.synchronize()
    for p in run_state.model.parameters():
        p.grad = None
    run_state.probs = None
    torch._C._cuda_clearCublasWorkspaces()
    opt = run_state.opt
    host = {p: {k: t.cpu() for k, t in st.items()} for p, st in opt.state.items()}
    opt.state.clear()
    dev = torch.cuda.current_device()
    sizes = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
             if seg["device"] == dev and tuple(seg["segment_pool_id"]) == (0, 0)
             and seg["segment_type"] == "large" and seg["active_size"] == 0]
    torch.cuda.empty_cache()
    for p, st in host.items():
        opt.state[p] = {k: t.to(p.device) for k, t in st.items()}
    return sizes


class EpochGraphs:
    """An epoch's pieces (``PIECES``) as CUDA graphs, captured once in one
    memory pool and replayed in capture order ("auc" only on the epochs that
    sample the AUC).

    ``state`` is what the pieces read and write.  What crosses an epoch or
    leaves ``run`` lives outside the pool: the masks, alpha and the carried
    AUC pair in buffers that ``load`` fills for each ``run``, the weights
    and Adam's state.  The pool holds the rest (activations, gradients, the
    probabilities and the metric row), which the next replay overwrites, so
    the runner copies the row and the last probabilities out.  The AUC
    piece writes only into its buffers, so skipping it leaves nothing stale
    in the pool.  Each replay credits the launch counts its capture counted
    (``ops/spmm_kernels.py``).

    The pool starts with the segments that the eager epochs had left free
    (``release_warm_up``): the capture then finds the free blocks an eager
    epoch finds and lays the epoch out as it does, so the process reserves
    what the eager path reserves.  A pool that starts empty fragments anew:
    up to a quarter more (gcn2_synth10m: four 4 GB segments, where the
    eager cache holds three and set-up's smaller ones)."""

    def __init__(self, key: tuple, pieces: Dict[str, Callable], run_state: SimpleNamespace):
        self.key = key
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.launches: Dict[str, spmm_kernels.LaunchCounts] = {}
        with profiling.span("runner.graph_capture"):
            sizes = release_warm_up(run_state)
            # buffers of its own for what each run fills, made after the
            # release so that they keep no freed segment (one device: the
            # loss reads the training masks as they are)
            masks = (run_state.tr_masks.clone(), run_state.va_masks.clone())
            self.state = SimpleNamespace(
                model=run_state.model, opt=run_state.opt, tr_masks=masks[0],
                va_masks=masks[1], tr_local=masks[0], alpha=run_state.alpha.clone(),
                auc=tuple(a.clone() for a in run_state.auc))
            pool = torch.cuda.graph_pool_handle()
            for name, piece in pieces.items():
                graph = torch.cuda.CUDAGraph()
                held = spmm_kernels.take_launches()
                try:
                    with torch.cuda.graph(graph, pool=pool):
                        # the released segments, reserved in the pool and free
                        reserved = [torch.empty(n, dtype=torch.uint8, device="cuda")
                                    for n in sizes]
                        del reserved
                        sizes = ()
                        piece(self.state)
                finally:
                    # a capture runs nothing: what it counted is each replay's
                    self.launches[name] = spmm_kernels.take_launches()
                    spmm_kernels.credit_launches(held)
                self.graphs[name] = graph
            # The capture stream's cuBLAS workspaces, made in the pool, go
            # back to it: the graphs use them only while they run, one after
            # another, and no later capture shares the pool.  Kept, they
            # would hold one of the pool's segments after ``release``.
            torch._C._cuda_clearCublasWorkspaces()

    def fits(self, key: tuple, model: torch.nn.Module) -> bool:
        return self.key == key and self.state.model is model

    def load(self, run_state: SimpleNamespace) -> None:
        """Copy a ``run`` call's masks, alpha and carried AUC pair into the
        buffers the graphs read."""
        st = self.state
        for mine, theirs in ((st.tr_masks, run_state.tr_masks),
                             (st.va_masks, run_state.va_masks), (st.alpha, run_state.alpha),
                             *zip(st.auc, run_state.auc)):
            mine.copy_(theirs)

    def adopt(self, opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
        """The captured optimizer, holding ``opt``'s state (zeros where
        ``opt`` has none: a fresh Adam), copied in place."""
        mine = self.state.opt
        if opt is not mine:
            for p in self.state.model.parameters():
                theirs = opt.state.get(p, {})
                for k, t in mine.state[p].items():
                    if k in theirs:
                        t.copy_(theirs[k])
                    else:
                        t.zero_()
        return mine

    def replay(self, name: str) -> None:
        self.graphs[name].replay()
        spmm_kernels.credit_launches(self.launches[name])

    def release(self) -> None:
        """Free the graphs and their pool (the card is synchronised first:
        a graph may still run)."""
        torch.cuda.synchronize()
        for p in self.state.model.parameters():
            p.grad = None
        self.graphs.clear()
        self.state = None
        torch.cuda.empty_cache()


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
    _eager: bool = False,
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

    On one CUDA device the epochs replay CUDA graphs (``EpochGraphs``) once
    an eager epoch has run under the same ``graph_key`` and the optimizer
    has stepped; they are captured again only when the key changes.  A
    fresh optimizer over the same parameters does not change it: its state
    is copied into the captured one, which ``run`` returns.  ``_eager``
    keeps every epoch eager (the card tests' reference).

    Reference quirks kept: the val loss and the predictions use the
    pre-update forward; the training loss is the sum of per-fold losses,
    so each fold's gradient is its own."""
    device = labels.device
    n_rows = labels.shape[0]
    w = torch.as_tensor(np.asarray(class_weight), dtype=torch.float32, device=device)
    auc_every = max(int(cfg.auc_every or 1), 1)
    n_metric = len(HIST_COLS)
    y_local = labels if local_labels is None else local_labels
    sharded = any(f is not None for f in (local_labels, local_masks, all_reduce,
                                          gather_rows, fold_slice, gather_folds))
    use_graphs = device.type == "cuda" and not sharded and not _eager
    # the runner's graphs, and the key of its last eager epoch
    cache = {"graphs": None, "warm": None}

    def forward_piece(s):
        s.probs = forward(s.model).transpose(0, 1)           # (B_l, R, C)

    def backward_piece(s):
        sums, count = masked_bce_sums(s.probs, y_local, s.tr_local, w)
        tot_sums, tot_count = sums.detach(), count
        if all_reduce is not None:
            st = torch.cat([tot_sums, count[:, None]], dim=-1)
            all_reduce(st)
            tot_sums, tot_count = st[:, :-1], st[:, -1]
        s.opt.zero_grad(set_to_none=True)
        bce_from_sums(sums, tot_count).sum().backward()
        if all_reduce is not None:
            grads = [q.grad for q in s.model.parameters()]
            flat = torch.cat([g.reshape(-1) for g in grads])
            all_reduce(flat)
            for g, v in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(v.view_as(g))
        # the autograd graph is freed here, not where the epoch returns;
        # the val loss and the predictions read the PRE-update forward
        del sums
        s.tot_sums, s.tot_count = tot_sums, tot_count
        s.probs = s.probs.detach()

    def adam_piece(s):
        s.opt.step()

    @torch.no_grad()
    def losses_piece(s):
        s.train_losses = bce_from_sums(s.tot_sums, s.tot_count)
        if gather_rows is not None:
            s.probs = gather_rows(s.probs)                   # (B_l, N, C)

    @torch.no_grad()
    def auc_piece(s):
        s.auc[0].copy_(micro_auc(s.probs, labels, s.va_masks))
        s.auc[1].copy_(macro_auc(s.probs, labels, s.va_masks))

    @torch.no_grad()
    def metrics_piece(s):
        probs, va_masks = s.probs, s.va_masks
        with profiling.span("metrics.multi_loss"):
            val_losses = multi_loss(probs, labels, va_masks, w)
        with profiling.span("metrics.protein_loc_correction"):
            preds = protein_loc_correction(probs, s.alpha, node_valid)
        with profiling.span("metrics.aim_cov_acc"):
            tr_m = aim_cov_acc(labels, preds, s.tr_masks)
            va_m = aim_cov_acc(labels, preds, va_masks)
        with profiling.span("metrics.f1"):
            f1 = (micro_f1(labels, preds, va_masks), macro_f1(labels, preds, va_masks))
        with profiling.span("metrics.row"):
            pred_num = torch.where(node_valid[:, None], preds, 0.0).sum(-2)
            cols = torch.stack([*tr_m, s.train_losses, *va_m, val_losses, *f1, *s.auc],
                               dim=-1)
            s.row = torch.cat([cols, pred_num], dim=-1)

    pieces = dict(zip(PIECES, (forward_piece, backward_piece, adam_piece, losses_piece,
                               auc_piece, metrics_piece)))
    if not cfg.compute_auc:
        del pieces["auc"]

    def epoch(s, graphs: Optional[EpochGraphs], auc_now: bool, timer: EpochTimer):
        """One epoch on ``s``, eager or, with ``graphs``, replayed; returns
        its metric row."""
        def run_piece(name):
            if graphs is None:
                pieces[name](s)
            else:
                graphs.replay(name)

        with timer.phase("forward"):
            run_piece("forward")
        with timer.phase("backward"):
            run_piece("backward")
        with timer.phase("adam"):
            run_piece("adam")
        with profiling.span("runner.metrics"):
            run_piece("losses")
            if auc_now:
                timer.mark("metrics")
                with timer.phase("auc"):
                    run_piece("auc")
            run_piece("metrics")
            # a replay's row is the pool's, which the next replay overwrites
            row = s.row if graphs is None else s.row.clone()
            # The epoch's last launch, after the last span inside the epoch
            # has closed: in a profiled run a range's close costs host time,
            # and host time after the last launch is device idle.
            timer.mark("metrics")
        return row

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
            b = tr_masks.shape[0]
            if last_auc is None:
                auc = (torch.full((b,), 0.5, device=device),
                       torch.full((b,), 0.5, device=device))
            else:
                auc = tuple(torch.as_tensor(a, device=device)[folds].clone() for a in last_auc)
            s = SimpleNamespace(
                model=model, opt=opt, tr_masks=tr_masks, va_masks=va_masks,
                tr_local=tr_masks if local_masks is None else local_masks(tr_masks),
                alpha=torch.full((), alpha, dtype=torch.float32, device=device), auc=auc)
            key = graph_key(model, opt, b, pieces) if use_graphs else None
            graphs = cache["graphs"]
            if graphs is not None and not graphs.fits(key, model):
                graphs.release()
                graphs = cache["graphs"] = None
            if graphs is not None:
                graphs.load(s)
                s, opt = graphs.state, graphs.adopt(opt)
            rows = []
            timer = EpochTimer(device)
            for e in range(epoch_offset, epoch_offset + n_run):
                with profiling.span("runner.epoch"):
                    if (graphs is None and key is not None and cache["warm"] == key
                            and opt.param_groups[0].get("capturable") and has_state(opt, model)):
                        graphs = cache["graphs"] = EpochGraphs(key, pieces, s)
                        s = graphs.state
                    timer.start(replayed=graphs is not None)
                    rows.append(epoch(s, graphs, cfg.compute_auc
                                      and auc_sample_now(e, total, auc_every), timer))
                    if graphs is None:
                        cache["warm"] = key
            with profiling.span("runner.stretch_end"):
                probs = s.probs if graphs is None else s.probs.clone()
                hist = torch.stack(rows, dim=1)                  # (B_l, E, 12 + C)
                if gather_folds is not None:
                    hist, probs = gather_folds(hist), gather_folds(probs)
                hist = hist.cpu().numpy()
                epoch_ms = timer.elapsed_ms()
                history = {"train": {}, "val": {}}
                for i, (split, key_) in enumerate(HIST_COLS):
                    if key_.startswith("auc") and not cfg.compute_auc:
                        continue
                    history[split][key_] = hist[:, :, i]
                history["pred_num"] = hist[:, :, n_metric:].astype(np.int32)
            return model, opt, probs, history, epoch_ms

    run.pieces = pieces                # the epoch's pieces, as ``graph_key`` reads them
    return run
