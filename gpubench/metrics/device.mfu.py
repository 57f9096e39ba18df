"""The whole step: the dense layers' model FLOPs of an epoch (``counts.py``)
over the untraced window's wall time per epoch, as a share of the card's
float32 peak outside the tensor cores (TF32 is off), in %."""


def read(ctx):
    if ctx.peaks is None:
        return None
    return 100.0 * ctx.flops_per_epoch / ctx.wall_per_epoch_s / ctx.peaks["fp32_flops_per_s"]
