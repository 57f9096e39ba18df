"""The two public helpers the port lacked, against the JAX package:
``data_normalize`` (a per-column float64 z-score; the same numpy
operations in the same order, so bit-exact) and ``all_round_masks``
(every round's KFold masks, stacked; exact)."""
import numpy as np
import pytest

from plagnn_tpu import data as jax_data
from plagnn_tpu import train as jax_train
from plagnn_tpu_torch import data
from plagnn_tpu_torch import train


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_data_normalize_matches_jax(dtype):
    rng = np.random.default_rng(4)
    mat = (rng.standard_normal((57, 9)) * 30 + 5).astype(dtype)
    got = data.data_normalize(mat)
    assert got.dtype == np.float64 and got is not mat
    np.testing.assert_array_equal(got, jax_data.data_normalize(mat))
    np.testing.assert_allclose(got.mean(0), 0.0, atol=1e-12)


def test_all_round_masks_match_jax():
    label_list = np.sort(np.random.default_rng(2).choice(300, 170, replace=False))
    got = train.all_round_masks(label_list, 384, 10)
    want = jax_train.all_round_masks(label_list, 384, 10)
    assert got[0].shape == (10, 10, 384)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    seeds = (12, 52)
    for a, b in zip(train.all_round_masks(label_list, 384, 3, seeds),
                    jax_train.all_round_masks(label_list, 384, 3, seeds)):
        np.testing.assert_array_equal(a, b)
