"""K-fold split generation, fold membership equal to sklearn's KFold.

Port of ``plagnn_tpu/train/kfold.py``.  The reference uses
``sklearn.model_selection.KFold(n_splits, shuffle=True, random_state=fseed)``
over ``label_with_loc_list`` with fold seeds [12, 22, ..., 100]; sklearn is
not a dependency of the port, so the split is re-implemented: shuffle
``arange(n)`` with ``np.random.RandomState(fseed)``, then cut consecutive
validation folds of sizes ``n // k``, the first ``n % k`` one larger.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

FOLD_SEEDS = (12, 22, 32, 42, 52, 62, 72, 82, 92, 100)


def kfold_val_indices(n: int, n_splits: int, seed: int) -> Iterator[np.ndarray]:
    """Validation positions of each fold, as sklearn's shuffled KFold."""
    ix = np.arange(n)
    np.random.RandomState(seed).shuffle(ix)
    sizes = np.full(n_splits, n // n_splits, dtype=np.int64)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        yield ix[start:start + size]
        start += size


def fold_node_masks(
    label_indices: Sequence[int],
    n_pad_nodes: int,
    fold_num: int,
    fseed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Boolean (fold_num, N_pad) train/val node masks for one round.

    KFold splits *positions* in ``label_indices`` (the annotated node ids),
    which map back to node ids."""
    label_indices = np.asarray(label_indices)
    train_masks = np.zeros((fold_num, n_pad_nodes), bool)
    val_masks = np.zeros((fold_num, n_pad_nodes), bool)
    for f, va in enumerate(kfold_val_indices(len(label_indices), fold_num, fseed)):
        train_masks[f, label_indices] = True
        train_masks[f, label_indices[va]] = False
        val_masks[f, label_indices[va]] = True
    return train_masks, val_masks


def all_round_masks(
    label_indices: Sequence[int],
    n_pad_nodes: int,
    fold_num: int,
    fold_seeds: Sequence[int] = FOLD_SEEDS,
) -> Tuple[np.ndarray, np.ndarray]:
    """(rounds, fold_num, N_pad) train/val masks of every round, stacked
    (``plagnn_tpu/train/kfold.py: all_round_masks``)."""
    trs, vas = zip(*(fold_node_masks(label_indices, n_pad_nodes, fold_num, s)
                     for s in fold_seeds))
    return np.stack(trs), np.stack(vas)
