"""Runner epoch: the mean ``forward`` phase over the untraced window's epochs, in
ms on the card's clock (``train/runner.py: EpochTimer``'s marks): the model's
forward, ``forward(model)``."""
from gpubench.spans import phase_mean_ms


def read(ctx):
    return phase_mean_ms(ctx, "forward")
