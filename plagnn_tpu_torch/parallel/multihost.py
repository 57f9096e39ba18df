"""Process-group bring-up.

Port of ``plagnn_tpu/parallel/multihost.py``.  JAX needs one
``jax.distributed.initialize`` per process before its devices span hosts;
the port needs one ``torch.distributed.init_process_group`` per rank, with
an explicit ``tcp://`` address (nothing on the card's machines announces a
cluster), a backend the caller names (``nccl`` for ranks that have a card
each, ``gloo`` for CPU ranks or ranks that share a card) and a finite
timeout, so that a rank that dies makes the others raise instead of hang.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def launcher_environment() -> bool:
    """True under ``torchrun`` (or any launcher that sets its variables)."""
    return all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                         "WORLD_SIZE"))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> int:
    """Join the process group; returns the world size.

    The address is ``coordinator_address`` ("host:port"), else
    ``COORDINATOR_ADDRESS`` (the JAX package's variable, with
    ``NUM_PROCESSES`` / ``PROCESS_ID``), else torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` with ``WORLD_SIZE`` / ``RANK``.  With none of them the
    run is a single process: nothing is initialised and 1 is returned.
    A group that is already initialised is kept (its size is returned)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dist.is_initialized():
        return dist.get_world_size()
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        world = num_processes if num_processes is not None else os.environ.get(
            "NUM_PROCESSES")
        rank = process_id if process_id is not None else os.environ.get("PROCESS_ID")
    elif launcher_environment():
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        world = num_processes if num_processes is not None else os.environ["WORLD_SIZE"]
        rank = process_id if process_id is not None else os.environ["RANK"]
    else:
        return 1
    if world is None or rank is None:
        raise ValueError(f"coordinator {addr!r} given without the number of "
                         "processes and this process's id")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=int(world),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()
