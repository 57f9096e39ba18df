"""What the runner's CUDA graphs rest on, on the CPU: the runner stays eager
here and with a sharded callable; the launch counters' bookkeeping for
replays; ``make_adam``'s ``capturable`` switch; what ``graph_key`` changes
on; the threshold correction's device fill.  The graphs themselves run on
the card (``tests/test_torch_cuda_graphs.py``)."""
import numpy as np
import pytest
import torch

from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph
from plagnn_tpu_torch.train import engine, losses, postprocess, runner
from plagnn_tpu_torch.utils import precision, profiling

N, C, F, B = 40, 12, 16, 2
HIDDEN = (8, 6, 5, 4)


@pytest.fixture(autouse=True)
def _empty_registries():
    profiling.reset()
    yield
    profiling.reset()


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, 160), rng.integers(0, N, 160)
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
    split = torch.from_numpy(rng.random((B, N)) < 0.7)
    tr = torch.zeros((B, n), dtype=torch.bool)
    va = torch.zeros((B, n), dtype=torch.bool)
    tr[:, :N], va[:, :N] = split, ~split
    return graph, feats, labels, losses.weight_cal(loc), torch.arange(n) < N, tr, va


def _cfg(**kw):
    return engine.TrainConfig(**{**dict(lr=1e-3, epoch_num=6, fold_batch=B, hidden=HIDDEN,
                                        auc_every=2, verbose=False), **kw})


@pytest.mark.parametrize("sharded", [False, True])
def test_the_runner_stays_eager_on_the_cpu(sharded):
    """On the CPU, and with the collectives of a sharded runner, every epoch
    runs eagerly (recorded as such) and nothing is captured; the optimizer
    that ``run`` returns is the one it was given."""
    graph, feats, labels, w, valid, tr, va = _inputs()
    cfg = _cfg()
    collectives = dict(all_reduce=lambda t: None, gather_rows=lambda p: p,
                       gather_folds=lambda t: t) if sharded else {}
    run = runner.make_fold_runner(lambda m: m(graph, feats), labels, w, valid, cfg,
                                  **collectives)
    model = engine.init_fold_model(cfg, F, [1, 2], "cpu")
    opt = runner.make_adam(model, cfg)
    for offset in (0, 3):
        _, got, _, _, ms = run(model, opt, tr, va, 0.1, n_epochs=3, epoch_offset=offset,
                               total_epochs=6)
        assert got is opt and len(ms) == 3
    assert profiling.EPOCH_REPLAYED == [False] * 6
    assert len(profiling.PHASES) == 6
    assert "runner.graph_capture" not in profiling.SPANS


def test_make_adam_is_capturable_on_cuda_parameters_only():
    model = torch.nn.Linear(3, 2)
    opt = runner.make_adam(model, engine.TrainConfig())
    assert opt.param_groups[0]["capturable"] is False
    model(torch.ones(1, 3)).sum().backward()
    opt.step()                                     # a CPU step: torch would refuse capturable
    assert runner.has_state(opt, model)


@pytest.fixture
def registries(monkeypatch):
    """The three launch registries as small dicts of the test's own."""
    monkeypatch.setattr(sk, "LAUNCHES", {"a": 3, "b": 1})
    monkeypatch.setattr(sk, "LAUNCH_SHAPES", {("a", 10, 20, 4): 3})
    monkeypatch.setattr(sk, "LAUNCH_SLICES", {("a", 10, 4): 1024})
    return sk.LAUNCHES, sk.LAUNCH_SHAPES, sk.LAUNCH_SLICES


def _capture(launches, shapes, slices):
    """What one capture's wrappers count, into the live registries."""
    launches["a"] += 2
    shapes[("a", 10, 20, 8)] = shapes.get(("a", 10, 20, 8), 0) + 2
    slices[("a", 10, 8)] = 256


def test_take_launches_holds_what_a_capture_counted(registries):
    """Taken before and after a capture, the registries give the capture's
    own counts, and they are left empty in place."""
    held = sk.take_launches()
    assert held == ({"a": 3, "b": 1}, {("a", 10, 20, 4): 3}, {("a", 10, 4): 1024})
    _capture(*registries)
    assert sk.take_launches() == ({"a": 2, "b": 0}, {("a", 10, 20, 8): 2},
                                  {("a", 10, 8): 256})
    assert registries == ({"a": 0, "b": 0}, {}, {})
    assert sk.LAUNCHES is registries[0]


def test_credit_launches_counts_a_capture_once_per_replay(registries):
    """The counts held back over a capture, credited again, and three
    replays credited, read as the capture's launches run eagerly three
    times."""
    held = sk.take_launches()
    _capture(*registries)
    captured = sk.take_launches()
    sk.credit_launches(held)
    assert registries == held
    for _ in range(3):
        sk.credit_launches(captured)
    eager = tuple(dict(r) for r in held)
    for _ in range(3):
        _capture(*eager)
    assert registries == eager


def test_a_failed_capture_leaves_the_counts_it_held(registries):
    """``EpochGraphs``' bookkeeping: what a capture that raises counted is
    taken away, and what was held is credited back."""
    want = tuple(dict(r) for r in registries)
    held = sk.take_launches()
    with pytest.raises(RuntimeError):
        try:
            _capture(*registries)
            raise RuntimeError("capture refused")
        finally:
            sk.take_launches()
            sk.credit_launches(held)
    assert registries == want


def _runner(cfg):
    graph, feats, *rest = _inputs()
    labels, w, valid = rest[0], rest[1], rest[2]
    return runner.make_fold_runner(lambda m: m(graph, feats), labels, w, valid, cfg)


def _key(model, opt, cfg=None, folds=B):
    return runner.graph_key(model, opt, folds, _runner(cfg or _cfg()).pieces)


def test_graph_key_holds_for_a_fresh_adam_over_the_same_parameters():
    cfg = _cfg()
    model = engine.init_fold_model(cfg, F, [1, 2], "cpu")
    assert _key(model, runner.make_adam(model, cfg)) == _key(model, runner.make_adam(model, cfg))
    assert _key(model, runner.make_adam(model, cfg), folds=B + 1) != _key(
        model, runner.make_adam(model, cfg))


def test_looked_up_names_what_the_pieces_call():
    """The key reads the functions the pieces call by name, found in their
    code, the AUC's too where the runner samples it."""
    names = {n for n, _ in runner.looked_up(_runner(_cfg()).pieces)}
    assert {"masked_bce_sums", "bce_from_sums", "multi_loss", "protein_loc_correction",
            "aim_cov_acc", "micro_f1", "macro_f1", "micro_auc", "macro_auc"} <= names
    names = {n for n, _ in runner.looked_up(_runner(_cfg(compute_auc=False)).pieces)}
    assert "micro_auc" not in names and "protein_loc_correction" in names


@pytest.mark.parametrize("change", ["model", "lr", "eps", "matmul", "agg_dtype", "patched",
                                    "patched_loss", "patched_step"])
def test_graph_key_changes_with_what_the_graphs_bake_in(change, monkeypatch):
    cfg = _cfg()
    model = engine.init_fold_model(cfg, F, [1, 2], "cpu")
    key = _key(model, runner.make_adam(model, cfg))
    opt = runner.make_adam(model, cfg)
    if change == "model":
        model = engine.init_fold_model(cfg, F, [1, 2], "cpu")
        opt = runner.make_adam(model, cfg)
    elif change == "lr":
        opt = runner.make_adam(model, _cfg(lr=2e-3))
    elif change == "eps":
        opt.param_groups[0]["eps"] = 1e-6
    elif change == "matmul":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    elif change == "agg_dtype":
        monkeypatch.setattr(precision, "_AGG_DTYPE", torch.bfloat16)
    elif change == "patched":
        monkeypatch.setattr(runner, "protein_loc_correction",
                            lambda p, a, v=None: postprocess.protein_loc_correction(p, a, v))
    elif change == "patched_loss":
        monkeypatch.setattr(runner, "masked_bce_sums",
                            lambda *a: losses.masked_bce_sums(*a))
    else:
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert _key(model, opt) != key


@pytest.mark.parametrize("alpha", [0.1, 0.37])
def test_protein_loc_correction_with_padding_rows_matches_its_numpy_twin(alpha):
    """The fill that replaced the host copy gives the numpy twin's decisions
    on the valid rows and zeros on the padding rows; on float32
    probabilities alpha as a float and as the runner's 0-d float32 tensor
    give the same decisions."""
    rng = np.random.default_rng(11)
    probs = rng.random((3, 50, C))
    probs[:, 40:] = 7.0                      # padding rows: outside every statistic
    valid = torch.arange(50) < 40
    got = postprocess.protein_loc_correction(torch.from_numpy(probs), alpha, valid)
    assert not got[:, 40:].any()
    for b in range(3):
        want = postprocess.protein_loc_correction_np(probs[b, :40], alpha)
        np.testing.assert_array_equal(got[b, :40].numpy(), want)
    p32 = torch.from_numpy(probs.astype(np.float32))
    assert torch.equal(postprocess.protein_loc_correction(p32, alpha, valid),
                       postprocess.protein_loc_correction(
                           p32, torch.full((), alpha, dtype=torch.float32), valid))


def test_summary_counts_the_replayed_epochs():
    profiling.PHASES.extend(dict.fromkeys(runner.EPOCH_PHASES, 1.0) for _ in range(3))
    profiling.EPOCH_REPLAYED.extend([False, True, True])
    assert profiling.summary().endswith("2 replayed from CUDA graphs")
    profiling.reset()
    assert profiling.EPOCH_REPLAYED == []
