"""The readers of the port's own spans and epoch phases, on a registry filled
by hand: the window's rows found by their place, checked against the
window's ``epoch_ms``, and None where they do not line up or are missing."""
import json

import pytest

from gpubench import spans
from gpubench.harness import ROOT, MetricContext, load_reader
from gpubench.tracing import Trace
from plagnn_tpu_torch.utils import profiling

PHASES = ("forward", "backward", "adam", "metrics", "auc")
RUNNER = tuple(f"runner.{p}_ms" for p in PHASES)
SETUP = ("setup.optimizer_init_s", "setup.kernel_load_s", "setup.first_epoch_s")


@pytest.fixture(autouse=True)
def _empty_registries():
    profiling.reset()
    yield
    profiling.reset()


def _row(fwd, bwd, adam, metrics, auc=0.0):
    return dict(zip(PHASES, (fwd, bwd, adam, metrics, auc)))


def _ctx(epoch_ms, traced_epochs=2):
    trace = Trace(kernels=[], window=(0.0, 1e6), gaps=[], lost=0)
    return MetricContext(trace=trace, traced_epochs=traced_epochs, epoch_ms=list(epoch_ms),
                         wall_per_epoch_s=0.5, flops_per_epoch=1.0, agg_bytes_per_epoch=1,
                         peaks=None, graph_build_s=1.5)


WINDOW = [_row(4.0, 5.0, 1.0, 2.0, 3.0), _row(4.5, 5.0, 1.0, 2.5), _row(3.5, 6.0, 1.0, 1.5)]


def _fill(before=3, traced=2):
    """Checked steps and the rest of the first stretch, the window, the traced
    stretches; returns the window's epoch_ms."""
    profiling.PHASES.extend(_row(50.0, 50.0, 50.0, 50.0, 50.0) for _ in range(before))
    profiling.PHASES.extend(dict(r) for r in WINDOW)
    profiling.PHASES.extend(_row(9.0, 9.0, 9.0, 9.0) for _ in range(traced))
    return [sum(r.values()) for r in WINDOW]


def test_each_phase_reader_takes_the_window_rows_only():
    ctx = _ctx(_fill())
    read = {n: load_reader(n).read(ctx) for n in RUNNER}
    assert read == {"runner.forward_ms": 4.0, "runner.backward_ms": pytest.approx(16 / 3),
                    "runner.adam_ms": 1.0, "runner.metrics_ms": 2.0, "runner.auc_ms": 1.0}


def test_the_five_phases_add_up_to_the_window_mean_epoch():
    epoch_ms = _fill(before=5, traced=4)
    ctx = _ctx(epoch_ms, traced_epochs=4)
    total = sum(load_reader(n).read(ctx) for n in RUNNER)
    assert total == pytest.approx(sum(epoch_ms) / len(epoch_ms), rel=1e-12)


@pytest.mark.parametrize("shift", ["one row more after", "one row fewer after",
                                   "epoch_ms off by 0.02"])
def test_a_misaligned_registry_reads_none(shift):
    epoch_ms = _fill()
    if shift == "one row more after":
        profiling.PHASES.append(_row(9.0, 9.0, 9.0, 9.0))
    elif shift == "one row fewer after":
        profiling.PHASES.pop()
    else:
        epoch_ms[1] += 0.02
    ctx = _ctx(epoch_ms)
    assert spans.window_phase_rows(ctx) is None
    assert all(load_reader(n).read(ctx) is None for n in RUNNER)


def test_a_row_within_the_tolerance_still_reads():
    epoch_ms = _fill()
    epoch_ms[0] += 0.005
    assert load_reader("runner.forward_ms").read(_ctx(epoch_ms)) == 4.0


def test_too_few_rows_or_none_read_none():
    ctx = _ctx([1.0, 2.0, 3.0, 4.0])
    assert all(load_reader(n).read(ctx) is None for n in RUNNER)
    profiling.PHASES.extend(_row(1.0, 0.0, 0.0, 0.0) for _ in range(5))
    assert all(load_reader(n).read(ctx) is None for n in RUNNER)   # 5 < 4 + 2


def test_a_port_without_the_registries_reads_none(monkeypatch):
    epoch_ms = _fill()
    profiling.SPANS["runner.epoch"] = profiling.SpanStats(1, 2.0, 2.0)
    monkeypatch.delattr(profiling, "PHASES")
    monkeypatch.delattr(profiling, "SPANS")
    ctx = _ctx(epoch_ms)
    assert all(load_reader(n).read(ctx) is None for n in RUNNER + SETUP)


def test_setup_readers_take_totals_and_the_first_epoch():
    profiling.SPANS["setup.optimizer_init"] = profiling.SpanStats(3, 9.5, 9.0)
    profiling.SPANS["setup.kernel_load"] = profiling.SpanStats(2, 0.25, 0.2)
    profiling.SPANS["runner.epoch"] = profiling.SpanStats(400, 6.0, 1.75)
    ctx = _ctx([])
    read = {n: load_reader(n).read(ctx) for n in SETUP}
    assert read == {"setup.optimizer_init_s": 9.5, "setup.kernel_load_s": 0.25,
                    "setup.first_epoch_s": 1.75}
    profiling.reset()
    assert all(load_reader(n).read(ctx) is None for n in SETUP)


def test_the_entries_name_every_cell_and_the_program_as_source():
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = [w["name"] for w in bench["workloads"]]
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in RUNNER + SETUP:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["workloads"] == cells
        runner = name.startswith("runner.")
        assert m["layer"] == ("runner epoch" if runner else "set-up")
        assert m["moves"] == ("fold_epochs_per_s" if runner else "setup_s")
        assert m["unit"] == ("ms" if runner else "s")
