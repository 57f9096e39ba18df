"""Round-level resume.

Port of ``plagnn_tpu/train/checkpoint.py:142-148``.  Mid-round checkpoints
(``--checkpoint-every > 0``) are not ported yet; the engine refuses them.
"""
from __future__ import annotations

import os


def round_complete(path: str, round_idx: int, fold_num: int) -> bool:
    """True when every fold's logit artifact for a round exists."""
    return all(
        os.path.exists(os.path.join(path, f"{round_idx}_{f}_loc_logits.npy"))
        for f in range(1, fold_num + 1)
    )
