"""The runner's CUDA graphs against its eager epochs, on the card.

On one CUDA device ``train/runner.py`` runs the first epoch eagerly and
replays CUDA graphs from the second on.  Here the same training runs twice,
once forced eager (``make_fold_runner(_eager=True)``): 12 epochs in three
``run`` calls that cross a stretch boundary, epochs on and off the AUC's
cadence, and a round restart with the initial weights and a fresh Adam.
GCN2 and GNN32 (float32 and bfloat16 messages) give the same bits on both
paths; GAT, whose steps are not bit-identical run to run, agrees within its
kernels' card tolerance.  These need an NVIDIA card and nvcc and skip
without them.  On the card:

    python -m pytest tests/test_torch_cuda_graphs.py -q -m cuda --noconftest
"""
import collections
import os

import numpy as np
import pytest
import torch

from plagnn_tpu_torch.data.synthetic import synthetic_dataset
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph, from_scipy_coo, pad_features
from plagnn_tpu_torch.train import engine, losses, runner
from plagnn_tpu_torch.utils import precision, profiling

pytestmark = pytest.mark.cuda

N, F, C, B = 300, 24, 12, 3
# (epochs, epoch offset) of the three run calls over an 8-epoch round: the
# third starts the next round with a fresh Adam
CALLS = ((5, 0), (3, 5), (4, 0))
ROUND = 8
MODELS = {
    "gcn2": dict(model="gcn2", hidden=(16,)),
    "gnn32": dict(model="gnn32", hidden=(16, 12, 8, 6)),
    "gnn32_bf16": dict(model="gnn32", hidden=(16, 12, 8, 6)),
    "gat": dict(model="gat", hidden=(8, 8)),
}
# GAT's kernels against their plain versions on the card (tests/test_torch_gat.py)
GAT_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    before = precision.aggregation_dtype()
    profiling.reset()
    yield torch.device("cuda")
    precision.set_aggregation_dtype(before)
    profiling.reset()


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, N, 3000), np.arange(N)])
    dst = np.concatenate([rng.integers(0, N - 20, 3000), np.zeros(N, np.int64)])
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    graph = build_graph(pairs[:, 0], pairs[:, 1], N, add_self_loops=True)
    n = graph.n_nodes
    feats = torch.zeros(n, F)
    feats[:N] = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
    loc = (rng.random((N, C)) < 0.3).astype(np.float32)
    loc[np.arange(N), rng.integers(0, C, N)] = 1.0
    labels = torch.zeros(n, C)
    labels[:N] = torch.from_numpy(loc)
    split = rng.random((B, N)) < 0.7
    tr = np.zeros((B, n), bool)
    va = np.zeros((B, n), bool)
    tr[:, :N], va[:, :N] = split, ~split
    return graph, feats, labels, losses.weight_cal(loc), tr, va


def _train(name, eager, device):
    """The three run calls; per call (history, last probs, weights, Adam's
    state), and the launch counts they added."""
    precision.set_aggregation_dtype("bfloat16" if name.endswith("bf16") else "float32")
    graph, feats, labels, w, tr, va = _inputs()
    cfg = engine.TrainConfig(lr=1e-3, epoch_num=ROUND, fold_batch=B, auc_every=3,
                             verbose=False, **MODELS[name])
    g = graph.to(device)
    x, y = feats.to(device), labels.to(device)
    valid = torch.arange(g.n_nodes, device=device) < N
    run = runner.make_fold_runner(lambda m: m(g, x), y, w, valid, cfg, _eager=eager)
    model = engine.init_fold_model(cfg, F, list(range(1, B + 1)), device)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tr, va = torch.from_numpy(tr).to(device), torch.from_numpy(va).to(device)
    held = sk.take_launches()
    opt, last_auc, out = runner.make_adam(model, cfg), None, []
    for n, offset in CALLS:
        if offset == 0 and out:                       # a round restart
            model.load_state_dict(init)
            opt, last_auc = runner.make_adam(model, cfg), None
        _, opt, probs, hist, _ = run(model, opt, tr, va, 0.1, n_epochs=n,
                                     epoch_offset=offset, total_epochs=ROUND,
                                     last_auc=last_auc)
        last_auc = tuple(torch.as_tensor(hist["val"][k][:, -1], device=device)
                         for k in ("auc_micro", "auc_macro"))
        out.append((hist, probs.cpu(),
                    {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    [{k: t.cpu().clone() for k, t in opt.state[p].items()}
                     for p in model.parameters()]))
    torch.cuda.synchronize()
    launches = sk.take_launches()
    sk.credit_launches(held)
    return out, launches


def _leaves(call):
    hist, probs, weights, adam = call
    yield "probs", probs
    yield from weights.items()
    for i, st in enumerate(adam):
        yield from ((f"adam{i}.{k}", t) for k, t in st.items())


@pytest.mark.parametrize("name", list(MODELS))
def test_replayed_epochs_match_eager(card, name):
    eager, eager_launches = _train(name, True, card)
    assert not any(profiling.EPOCH_REPLAYED)
    profiling.reset()
    replayed, launches = _train(name, False, card)
    # epochs after the runner's first are replayed, from one capture
    assert profiling.EPOCH_REPLAYED == [False] + [True] * (sum(n for n, _ in CALLS) - 1)
    assert profiling.SPANS["runner.graph_capture"].count == 1
    assert launches[0] == eager_launches[0] and launches[1] == eager_launches[1]
    assert sum(launches[0].values()) > 0
    for want, got in zip(eager, replayed):
        assert set(want[0]) == set(got[0])
        for split in ("train", "val"):
            for k, v in want[0][split].items():
                if name == "gat":
                    if k == "loss":
                        np.testing.assert_allclose(got[0][split][k], v, **GAT_TOL)
                else:
                    np.testing.assert_array_equal(got[0][split][k], v, err_msg=f"{split}.{k}")
        if name != "gat":
            np.testing.assert_array_equal(got[0]["pred_num"], want[0]["pred_num"])
        for (k, a), (_, b) in zip(_leaves(want), _leaves(got)):
            if name == "gat":
                torch.testing.assert_close(b, a, rtol=GAT_TOL["rtol"],
                                           atol=GAT_TOL["atol"] * max(float(a.abs().max()), 1.0),
                                           msg=k)
            else:
                assert torch.equal(a, b), k


def test_a_new_model_or_precision_captures_again(card):
    """The graphs bake in the parameters and the matmul precision: a new
    model, or TF32 switched on, captures anew after one eager epoch."""
    graph, feats, labels, w, tr, va = _inputs()
    cfg = engine.TrainConfig(lr=1e-3, epoch_num=4, fold_batch=B, verbose=False,
                             **MODELS["gcn2"])
    g = graph.to(card)
    x, y = feats.to(card), labels.to(card)
    valid = torch.arange(g.n_nodes, device=card) < N
    tr, va = torch.from_numpy(tr).to(card), torch.from_numpy(va).to(card)
    run = runner.make_fold_runner(lambda m: m(g, x), y, w, valid, cfg)
    for seeds in ([1, 2, 3], [4, 5, 6]):
        model = engine.init_fold_model(cfg, F, seeds, card)
        run(model, None, tr, va, 0.1, n_epochs=3)
    before = precision.matmul_precision()
    precision.set_matmul_precision("high")
    try:
        run(model, None, tr, va, 0.1, n_epochs=3)
    finally:
        precision.set_matmul_precision(before)
    assert profiling.EPOCH_REPLAYED == [False, True, True] * 3
    assert profiling.SPANS["runner.graph_capture"].count == 3


def test_a_patched_piece_function_captures_again(card, monkeypatch):
    """A function that a piece looks up by name, patched after a capture (as
    the benchmark plants its faults), captures anew after one eager epoch,
    and the replays run the patched function."""
    graph, feats, labels, w, tr, va = _inputs()
    cfg = engine.TrainConfig(lr=1e-3, epoch_num=6, fold_batch=B, verbose=False,
                             **MODELS["gcn2"])
    g = graph.to(card)
    x, y = feats.to(card), labels.to(card)
    valid = torch.arange(g.n_nodes, device=card) < N
    tr, va = torch.from_numpy(tr).to(card), torch.from_numpy(va).to(card)
    run = runner.make_fold_runner(lambda m: m(g, x), y, w, valid, cfg)
    model = engine.init_fold_model(cfg, F, [1, 2, 3], card)
    _, opt, _, hist, _ = run(model, None, tr, va, 0.1, n_epochs=3, total_epochs=6)
    assert hist["pred_num"].any()
    sound = runner.protein_loc_correction
    monkeypatch.setattr(runner, "protein_loc_correction",
                        lambda p, a, v=None: torch.zeros_like(sound(p, a, v)))
    _, _, _, hist, _ = run(model, opt, tr, va, 0.1, n_epochs=3, epoch_offset=3,
                           total_epochs=6)
    assert profiling.EPOCH_REPLAYED == [False, True, True] * 2
    assert profiling.SPANS["runner.graph_capture"].count == 2
    assert not hist["pred_num"].any()


def test_the_profiler_sees_the_replayed_kernels(card, tmp_path):
    """A profiled stretch of replays holds every aggregation and GEMM kernel
    that a profiled eager stretch holds."""
    graph, feats, labels, w, tr, va = _inputs()
    cfg = engine.TrainConfig(lr=1e-3, epoch_num=8, fold_batch=B, verbose=False,
                             **MODELS["gcn2"])
    g = graph.to(card)
    x, y = feats.to(card), labels.to(card)
    valid = torch.arange(g.n_nodes, device=card) < N
    tr, va = torch.from_numpy(tr).to(card), torch.from_numpy(va).to(card)
    counts = []
    for eager in (True, False):
        run = runner.make_fold_runner(lambda m: m(g, x), y, w, valid, cfg, _eager=eager)
        model = engine.init_fold_model(cfg, F, [1, 2, 3], card)
        _, opt, _, _, _ = run(model, None, tr, va, 0.1, n_epochs=3, total_epochs=8)
        path = tmp_path / ("eager" if eager else "graphs")
        with profiling.trace(str(path)):
            run(model, opt, tr, va, 0.1, n_epochs=4, epoch_offset=3, total_epochs=8)
        names = [n for n, _ in profiling.block_device_events(str(path / profiling.TRACE_FILE))]
        counts.append(collections.Counter(n for n in names
                                          if "spmm" in n or "gemm" in n.lower()))
    assert profiling.EPOCH_REPLAYED[-4:] == [True] * 4
    assert sum(counts[0].values()) > 0
    assert counts[1] == counts[0]


def _tiny_train(tmp_dir, **cfg_kw):
    """tests/test_torch_checkpoint.py's 5 epochs x 2 folds, on the card;
    every artifact's bytes but txt_log.txt's."""
    ppi, feats, loc, label_list = synthetic_dataset(
        n_nodes=96, n_edges=500, seed=4, feature_dims=(3, 6, 6))
    graph = from_scipy_coo(ppi, add_self_loops=True)
    kw = dict(lr=1e-3, fold_num=2, epoch_num=5, fold_batch=2, fold_seeds=(12,),
              hidden=(13, 9, 7, 5), verbose=False)
    kw.update(cfg_kw)
    engine.train(graph, pad_features(feats, graph.n_nodes), pad_features(loc, graph.n_nodes),
                 label_list, loc, engine.TrainConfig(**kw), str(tmp_dir) + "/",
                 device_name="cuda")
    return {f: open(os.path.join(tmp_dir, f), "rb").read() for f in sorted(os.listdir(tmp_dir))
            if f != "txt_log.txt"}            # its lines carry the clock's time of day


@pytest.mark.parametrize("model", ["gnn32", "gcn2"])
def test_a_resumed_run_writes_the_same_bytes(card, tmp_path, model):
    """A run stopped after its first 2-epoch stretch (a checkpoint of the
    replayed epoch's weights and Adam state) and resumed by a new runner
    writes what the uninterrupted run writes, byte for byte."""
    ref = _tiny_train(tmp_path / "plain", model=model)
    calls = []

    def bomb(round_idx, alpha, start, done):
        calls.append(done)
        if len(calls) == 1:
            raise RuntimeError("injected crash")

    with pytest.raises(RuntimeError, match="injected crash"):
        _tiny_train(tmp_path / "crashy", model=model, checkpoint_every=2, chunk_callback=bomb)
    got = _tiny_train(tmp_path / "crashy", model=model, checkpoint_every=2)
    assert set(got) == set(ref) and "1_2_loc_logits.npy" in ref
    for f in ref:
        assert got[f] == ref[f], f
    assert sum(profiling.EPOCH_REPLAYED) > 0
