"""Data: artifact loading, preprocessing, synthetic bundles."""


def data_normalize(mat):
    """Per-column z-score in float64 (``plagnn_tpu/data/__init__.py:
    data_normalize``, the reference's utils.py): each column less its mean,
    over its population standard deviation.  A constant column divides by
    0, as the reference does.  The reference's main paths never call it."""
    import numpy as np

    out = np.array(mat, copy=True, dtype=np.float64)
    mean = out.mean(0)
    std = out.std(0)
    for j in range(out.shape[1]):
        out[:, j] = (out[:, j] - mean[j]) / std[j]
    return out
