"""``runner.graph_share`` on a registry filled by hand: the replayed share of
the window's epochs (the rows ``spans.window_phase_rows`` takes), and None
where the port records no flags or they do not line up with the rows."""
import pytest

from gpubench.harness import MetricContext, load_reader
from gpubench.tracing import Trace
from plagnn_tpu_torch.utils import profiling

PHASES = ("forward", "backward", "adam", "metrics", "auc")


@pytest.fixture(autouse=True)
def _empty_registries():
    profiling.reset()
    yield
    profiling.reset()


def _ctx(epoch_ms, traced_epochs):
    trace = Trace(kernels=[], window=(0.0, 1e6), gaps=[], lost=0)
    return MetricContext(trace=trace, traced_epochs=traced_epochs, epoch_ms=list(epoch_ms),
                         wall_per_epoch_s=0.5, flops_per_epoch=1.0, agg_bytes_per_epoch=1,
                         peaks=None, graph_build_s=1.5)


def _fill(flags):
    profiling.PHASES.extend(dict.fromkeys(PHASES, 1.0) for _ in flags)
    profiling.EPOCH_REPLAYED.extend(flags)


def test_the_share_of_the_window_only():
    # set-up (eager, then replays), the window, the traced stretch (eager after a capture)
    _fill([False, True, True] + [True, False, True, True] + [False, True])
    assert load_reader("runner.graph_share").read(_ctx([5.0] * 4, 2)) == 75.0


def test_none_without_flags_or_when_they_do_not_line_up():
    read = load_reader("runner.graph_share").read
    profiling.PHASES.extend(dict.fromkeys(PHASES, 1.0) for _ in range(6))
    assert read(_ctx([5.0] * 4, 2)) is None
    profiling.EPOCH_REPLAYED.extend([True] * 5)
    assert read(_ctx([5.0] * 4, 2)) is None
    profiling.EPOCH_REPLAYED.append(True)
    assert read(_ctx([5.0] * 4, 2)) == 100.0
    assert read(_ctx([6.0] * 4, 2)) is None        # the rows do not add up to epoch_ms
