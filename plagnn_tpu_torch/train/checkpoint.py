"""Checkpoint / resume.

Port of ``plagnn_tpu/train/checkpoint.py``:

* ``save_params`` / ``load_params``: a module's ``state_dict`` as a flat
  npz, one array per parameter name.
* ``save_state`` / ``load_state``: the mid-round checkpoint of one job chunk
  (model and Adam state, metric history, epochs done, config fingerprint)
  as a flat npz with a ``__meta__`` JSON record, written to a temporary file
  and renamed, so a kill mid-write never corrupts an existing checkpoint.
* ``round_complete``: the round-level resume predicate.

The port's checkpoints carry ``"framework": "torch"`` in their metadata.
Loading refuses any other file loudly: a JAX-written checkpoint (its optax
leaves do not map onto ``torch.optim.Adam``'s state), another schema
version, or a file that is no npz at all.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

# Bump on any layout change; loaders refuse other versions.
STATE_SCHEMA_VERSION = 1
FRAMEWORK = "torch"
_ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """A ``state_dict`` as an npz keyed by parameter name."""
    _atomic_savez(path, {k: v.detach().cpu().numpy() for k, v in state_dict.items()})


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` that ``save_params`` wrote (CPU tensors)."""
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def save_state(path: str, model: torch.nn.Module, opt: torch.optim.Adam,
               epochs_done: int, history: dict, config: dict) -> None:
    """Persist a job chunk's training state for a mid-round resume.

    The model's ``state_dict`` and Adam's per-parameter state (``step``
    included, so bias correction continues) are stored by name and index;
    ``history`` (the runner's nested dict of numpy arrays) keeps its key
    paths in the metadata; ``config`` is the run's fingerprint."""
    arrays = {f"p:{k}": v.detach().cpu().numpy()
              for k, v in model.state_dict().items()}
    opt_state = opt.state_dict()["state"]
    for i, st in opt_state.items():
        for key in _ADAM_KEYS:
            arrays[f"o{i}:{key}"] = st[key].detach().cpu().numpy()
    h_paths = []
    for split, v in history.items():
        items = v.items() if isinstance(v, Mapping) else [(None, v)]
        for key, leaf in items:
            kp = [split] if key is None else [split, key]
            arrays[f"h{len(h_paths)}"] = np.asarray(leaf)
            h_paths.append(kp)
    meta = {
        "framework": FRAMEWORK,
        "schema": STATE_SCHEMA_VERSION,
        "epochs_done": int(epochs_done),
        "config": config,
        "opt_params": sorted(int(i) for i in opt_state),
        "history_paths": h_paths,
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    _atomic_savez(path, arrays)


def _refuse(path: str, why: str):
    raise ValueError(f"checkpoint {path} {why}; delete it to restart this job "
                     "chunk from epoch 0")


def load_state(path: str) -> dict:
    """Read a checkpoint that ``save_state`` wrote.

    Returns ``{"model", "opt_state", "history", "epochs_done", "config"}``:
    ``model`` a ``state_dict``, ``opt_state`` Adam's per-parameter state by
    index (for ``restore_state``), ``history`` the nested dict as saved."""
    try:
        z = np.load(path)
    except (ValueError, OSError) as e:
        _refuse(path, f"is not an npz mid-round checkpoint ({e})")
    with z:
        if "__meta__" not in z.files:
            _refuse(path, "carries no schema metadata")
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("framework") != FRAMEWORK:
            _refuse(path, f"was written by framework {meta.get('framework')!r} "
                          f"(a JAX checkpoint has none), not by this {FRAMEWORK!r} "
                          "port: its optimizer state cannot be loaded")
        if meta.get("schema") != STATE_SCHEMA_VERSION:
            _refuse(path, f"has schema version {meta.get('schema')!r} but this "
                          f"build reads v{STATE_SCHEMA_VERSION}")
        model = {k[2:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("p:")}
        opt_state = {i: {key: torch.from_numpy(z[f"o{i}:{key}"]) for key in _ADAM_KEYS}
                     for i in meta["opt_params"]}
        history: dict = {}
        for i, kp in enumerate(meta["history_paths"]):
            d = history
            for k in kp[:-1]:
                d = d.setdefault(k, {})
            d[kp[-1]] = z[f"h{i}"]
    return {"model": model, "opt_state": opt_state, "history": history,
            "epochs_done": meta["epochs_done"], "config": meta["config"]}


def restore_state(st: dict, model: torch.nn.Module, opt: torch.optim.Adam) -> None:
    """Load a ``load_state`` result into a freshly built model and Adam (the
    config fingerprint guarantees the shapes line up)."""
    model.load_state_dict(st["model"])
    opt.load_state_dict({"state": st["opt_state"],
                         "param_groups": opt.state_dict()["param_groups"]})


def round_complete(path: str, round_idx: int, fold_num: int) -> bool:
    """True when every fold's logit artifact for a round exists."""
    return all(
        os.path.exists(os.path.join(path, f"{round_idx}_{f}_loc_logits.npy"))
        for f in range(1, fold_num + 1)
    )
