"""Runner epoch: the mean ``auc`` phase over all the untraced window's epochs,
0 on those off the AUC's cadence, in ms on the card's clock
(``train/runner.py: EpochTimer``'s marks): ``micro_auc`` and ``macro_auc``.
With the other four phases it adds up to the window's mean ``epoch_ms``."""
from gpubench.spans import phase_mean_ms


def read(ctx):
    return phase_mean_ms(ctx, "auc")
