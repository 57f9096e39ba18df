"""Runner epoch: the share of the untraced window's epochs that replayed the
runner's CUDA graphs instead of launching each kernel from Python, in %
(``train/runner.py``; ``utils/profiling.py: EPOCH_REPLAYED``, one flag per
row of ``PHASES``).  The window's epochs are those of
``gpubench/spans.py: window_phase_rows``; a port that records no flag
gives None."""
from gpubench.spans import window_phase_rows


def read(ctx):
    from plagnn_tpu_torch.utils import profiling

    flags = getattr(profiling, "EPOCH_REPLAYED", None)
    if not flags or len(flags) != len(profiling.PHASES) or window_phase_rows(ctx) is None:
        return None
    end = len(flags) - ctx.traced_epochs
    window = flags[end - len(ctx.epoch_ms):end]
    return 100.0 * sum(window) / len(window)
