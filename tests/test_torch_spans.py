"""The port's spans and the runner's epoch phases, on the CPU.

``utils.profiling.span`` adds every call to ``SPANS`` and is a profiler
range only inside a session; ``train.runner.EpochTimer`` appends one row of
``EPOCH_PHASES`` per epoch to ``PHASES``, which adds up to the epoch's
``epoch_ms``.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

from plagnn_tpu_torch.ops import _build
from plagnn_tpu_torch.ops.graph_format import build_graph
from plagnn_tpu_torch.train import engine, losses, runner
from plagnn_tpu_torch.utils import profiling

N, C, F, B = 40, 12, 16, 2
HIDDEN = (8, 6, 5, 4)


@pytest.fixture(autouse=True)
def _empty_registries():
    profiling.reset()
    yield
    profiling.reset()


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 160)
    dst = rng.integers(0, N, 160)
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
    return graph, feats, labels, losses.weight_cal(loc), torch.arange(n) < N, tr, va


def _run_two_stretches(auc_every=2, n1=3, n2=4, **collectives):
    graph, feats, labels, w, valid, tr, va = _inputs()
    cfg = engine.TrainConfig(lr=1e-3, epoch_num=n1 + n2, fold_batch=B, hidden=HIDDEN,
                             auc_every=auc_every, verbose=False)
    if collectives:
        run = runner.make_fold_runner(lambda m: m(graph, feats), labels, w, valid, cfg,
                                      **collectives)
    else:
        run = engine.make_batched_fold_runner(graph, feats, labels, w, valid, cfg)
    model = engine.init_fold_model(cfg, F, [1, 2], "cpu")
    tr, va = torch.from_numpy(tr), torch.from_numpy(va)
    _, opt, _, _, ms1 = run(model, None, tr, va, 0.1, n_epochs=n1, total_epochs=n1 + n2)
    _, _, _, _, ms2 = run(model, opt, tr, va, 0.1, n_epochs=n2, epoch_offset=n1,
                          total_epochs=n1 + n2)
    return ms1 + ms2


def _assert_rows_add_up(epoch_ms):
    rows = profiling.PHASES
    assert len(rows) == len(epoch_ms)
    for row, ms in zip(rows, epoch_ms):
        assert tuple(row) == runner.EPOCH_PHASES
        assert all(v >= 0.0 for v in row.values())
        assert sum(row.values()) == pytest.approx(ms, rel=1e-9, abs=1e-9)


def test_span_opens_no_range_outside_a_profiler_session(monkeypatch):
    opened = []

    class Recorder:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "record_function", Recorder)
    with profiling.span("test.outside"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("test.inside"):
            pass
    with profiling.span("test.after"):
        pass
    assert opened == ["test.inside"]
    assert set(profiling.SPANS) == {"test.outside", "test.inside", "test.after"}


def test_span_is_a_user_annotation_in_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("test.annotated"):
            torch.ones(4).sum()
    with open(os.path.join(str(tmp_path), profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("name") == "test.annotated" and ev.get("cat") == "user_annotation"
               for ev in events)


def test_spans_count_totals_and_first_durations(monkeypatch):
    clock = iter([10.0, 12.0, 20.0, 21.0, 30.0, 34.0, 40.0, 40.5])
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    for name in ("a", "a", "a", "b"):
        with profiling.span(name):
            pass
    a, b = profiling.SPANS["a"], profiling.SPANS["b"]
    assert (a.count, a.total_s, a.first_s) == (3, 7.0, 2.0)
    assert (b.count, b.total_s, b.first_s) == (1, 0.5, 0.5)


def test_a_span_that_raises_is_counted_and_lets_the_error_through():
    with pytest.raises(ValueError):
        with profiling.span("test.raises"):
            raise ValueError("inside")
    assert profiling.SPANS["test.raises"].count == 1


def test_runner_appends_one_phase_row_per_epoch_that_adds_up():
    epoch_ms = _run_two_stretches()
    assert len(epoch_ms) == 7
    _assert_rows_add_up(epoch_ms)
    spans = profiling.SPANS
    assert spans["runner.epoch"].count == 7
    assert spans["runner.run"].count == spans["runner.stretch_end"].count == 2
    for phase in ("forward", "backward", "adam"):
        assert spans[f"runner.{phase}"].count == 7
    for name in ("metrics.multi_loss", "metrics.protein_loc_correction", "metrics.f1",
                 "metrics.row"):
        assert spans[name].count == 7
    assert spans["metrics.aim_cov_acc"].count == 7
    assert spans["runner.metrics"].count == 7
    assert spans["runner.auc"].count == 4           # epochs 0, 2, 4 and the last


@pytest.mark.parametrize("auc_every, sampled", [(2, {0, 2, 4, 6}), (5, {0, 5, 6})])
def test_auc_is_zero_exactly_on_unsampled_epochs(auc_every, sampled):
    _run_two_stretches(auc_every=auc_every)
    got = {i for i, row in enumerate(profiling.PHASES) if row["auc"] != 0.0}
    assert got == sampled
    assert profiling.SPANS["runner.auc"].count == len(sampled)


def test_the_runner_with_collectives_marks_the_same_phases():
    calls = []

    def all_reduce(t):
        calls.append(tuple(t.shape))

    epoch_ms = _run_two_stretches(all_reduce=all_reduce, gather_rows=lambda p: p,
                                  gather_folds=lambda t: t)
    assert len(calls) == 2 * 7                    # the loss sums and the gradients
    _assert_rows_add_up(epoch_ms)


def test_make_adam_records_optimizer_init():
    model = torch.nn.Linear(3, 2)
    runner.make_adam(model, engine.TrainConfig())
    runner.make_adam(model, engine.TrainConfig())
    stats = profiling.SPANS["setup.optimizer_init"]
    assert stats.count == 2 and stats.total_s >= stats.first_s > 0.0


def test_kernel_load_is_a_span_on_a_miss_only(monkeypatch, tmp_path):
    lib = tmp_path / "fake.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "lib_path", lambda name: lib)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("handle", path))
    assert _build.load("spmm_sum") == ("handle", str(lib))
    assert _build.load("spmm_sum") == ("handle", str(lib))
    assert profiling.SPANS["setup.kernel_load"].count == 1


def test_reset_empties_both_registries_and_summary_reads_them():
    _run_two_stretches(n1=1, n2=1)
    text = profiling.summary()
    assert "runner.epoch" in text and "epoch phases, mean ms over 2 epochs" in text
    for phase in runner.EPOCH_PHASES:
        assert f"{phase} " in text.splitlines()[-1]
    spans, phases = profiling.SPANS, profiling.PHASES
    profiling.reset()
    assert profiling.SPANS is spans and profiling.PHASES is phases
    assert not spans and not phases
    assert profiling.summary().count("\n") == 0
