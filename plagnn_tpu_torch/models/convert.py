"""Carry parameters from the JAX package into the port.

The JAX package keeps parameters as nested dicts of arrays, weights stored
(in, out); the port's modules keep the same names and layout, so a pytree
of numpy arrays (one fold, or fold-stacked with a leading B axis) maps onto
a ``state_dict`` one leaf at a time.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{'conv1': {'w_pool': arr, ...}, ...} -> {'conv1.w_pool': tensor, ...},
    ready for ``GNN32.load_state_dict`` or ``BatchedGNN32.load_state_dict``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(params_from_jax(v, name + "."))
        else:
            out[name] = torch.from_numpy(np.array(v, dtype=np.float32))
    return out
