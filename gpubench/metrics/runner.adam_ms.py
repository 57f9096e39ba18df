"""Runner epoch: the mean ``adam`` phase over the untraced window's epochs, in ms
on the card's clock (``train/runner.py: EpochTimer``'s marks): ``opt.step()``."""
from gpubench.spans import phase_mean_ms


def read(ctx):
    return phase_mean_ms(ctx, "adam")
