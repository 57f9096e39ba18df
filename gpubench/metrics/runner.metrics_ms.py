"""Runner epoch: the mean ``metrics`` phase over the untraced window's epochs, in
ms on the card's clock (``train/runner.py: EpochTimer``'s marks): the val
loss, the threshold correction, AIM/COV/mlACC, F1, ``pred_num`` and the
history row."""
from gpubench.spans import phase_mean_ms


def read(ctx):
    return phase_mean_ms(ctx, "metrics")
