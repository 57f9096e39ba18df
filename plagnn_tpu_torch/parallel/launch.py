"""Local ranks in spawned processes.

The JAX package runs its ('fold', 'graph') mesh as one process over many
devices (conftest's 8 fake CPU devices in its tests).  PyTorch runs one
process per rank, so the port's stand-in is ``spawn_local``: ``world_size``
processes on the local host, each with its own device (a CPU rank, a card, or
a share of one card under gloo), joined through a ``file://`` rendezvous in
``rdzv_dir`` -- no port to pick, so concurrent test workers never collide.
The CLI, the tests and ``chip_smoke.py`` launch local meshes through it.
"""
from __future__ import annotations

import datetime
import os
import time
import uuid
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .multihost import DEFAULT_TIMEOUT_S


def _child(rank: int, fn: Callable, world_size: int, backend: str,
           devices: Sequence[str], rdzv_file: str, timeout_s: float, args):
    torch.set_num_threads(1)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"file://{rdzv_file}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def spawn_local(fn: Callable, world_size: int, *, backend: str,
                devices: Sequence[str], rdzv_dir: str, args: Sequence = (),
                timeout_s: Optional[float] = None,
                group_timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(rank, device, *args)`` in ``world_size`` spawned processes,
    rank r on ``devices[r]`` with a process group of ``backend`` (named by
    the caller: ``nccl`` for one card a rank, ``gloo`` otherwise).

    ``fn`` and ``args`` must pickle (a module-level function).  Each child
    runs ``torch.set_num_threads(1)``.  A child's exception fails the call
    (``torch.multiprocessing`` raises it here and ends the other ranks);
    ``timeout_s`` bounds the whole run (the ranks are killed and
    ``TimeoutError`` raised), and ``group_timeout_s`` each collective, so
    the ranks left behind by a dead one raise."""
    if len(devices) != world_size:
        raise ValueError(f"{world_size} ranks need {world_size} devices, got {len(devices)}")
    os.makedirs(rdzv_dir, exist_ok=True)
    rdzv_file = os.path.join(rdzv_dir, f"rdzv_{uuid.uuid4().hex}")
    ctx = mp.spawn(_child, nprocs=world_size, join=False, args=(
        fn, world_size, backend, list(devices), rdzv_file, group_timeout_s,
        tuple(args)))
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{world_size} local ranks did not finish in {timeout_s} s")
