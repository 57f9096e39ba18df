"""Runner epoch: the median of the CUDA-event ``epoch_ms`` that the port's
runner (``train/runner.py: EpochTimer``) returns for every epoch of the
window.  Its gap to 1000 x folds / ``fold_epochs_per_s`` is the cost of the
stretch boundaries."""
import statistics


def read(ctx):
    return statistics.median(ctx.epoch_ms) if ctx.epoch_ms else None
