"""Runner epoch: the mean ``backward`` phase over the untraced window's epochs,
in ms on the card's clock (``train/runner.py: EpochTimer``'s marks): the
masked BCE, the loss and gradient sums on a mesh, ``zero_grad`` and
``.backward()``."""
from gpubench.spans import phase_mean_ms


def read(ctx):
    return phase_mean_ms(ctx, "backward")
