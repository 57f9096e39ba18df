"""Tracing, spans and the epoch's phases.

* ``trace(log_dir)``: a ``torch.profiler.profile`` context that records
  the host and, where a card is present, its CUDA kernels, and writes a
  Chrome trace (``trace.json``, readable in Perfetto or chrome://tracing)
  into ``log_dir`` when the context ends.  With a card the session starts
  with a warm-up of tiny kernels, and it raises where the block launched
  kernels and the file holds none of them, and warns where it holds only
  some.
* ``span(name)``: a named stretch of host code.  Every call adds its host
  seconds to ``SPANS``; while a profiler session is active it is also a
  ``record_function`` range, so the Chrome trace names the host code
  behind each stretch of device idle.
* ``PHASES``: one row per epoch that the runner timed, phase -> ms on the
  device's clock (``train/runner.py: EpochTimer``); ``EPOCH_REPLAYED``
  beside it, whether that epoch replayed the runner's CUDA graphs or ran
  eagerly.  The span ``runner.graph_capture`` counts the captures.
* ``reset()`` empties the registries; ``summary()`` prints them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import warnings
from typing import Dict, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
# The block's range in the trace; launches outside it are the warm-up's.
TRACE_BLOCK = "plagnn_tpu_torch.trace block"
# Two ways a session loses kernels on an H100 (torch 2.11, CUDA 12.8).  The
# first kernels of a session can leave no event, the more the longer the
# process has run CUDA work (8 once phase 4p of chip_smoke.py has run),
# whatever the session waits or synchronises first.  So each session
# starts with WARMUP_LAUNCHES tiny kernels.  And the profiler drops a
# kernel whose start, moved onto the host clock, falls before its session,
# which at times lands milliseconds before the kernel's own launch.  So
# the session waits TRACE_MARGIN_S before the block and, the card
# synchronised, after it.
WARMUP_LAUNCHES = 64
TRACE_MARGIN_S = 0.1
_LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                           "cuLaunchKernel", "cuLaunchKernelEx"))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the ``torch.profiler.profile`` object."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if cuda:
            w = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                w.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        with record_function(TRACE_BLOCK):
            yield prof
            if cuda:
                torch.cuda.synchronize()
        if cuda:
            time.sleep(TRACE_MARGIN_S)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if cuda:
        lost, offsets, _ = kernel_launches(path)
        if lost and not offsets:
            raise RuntimeError(f"{path}: none of the {lost} kernel launches has a kernel event")
        if lost:
            warnings.warn(f"{path}: {lost} of {lost + len(offsets)} kernel launches have no "
                          f"kernel event; the recorded kernels start {min(offsets):.1f} us "
                          f"after their launches at the earliest")


def _block(path: str):
    """The events of the Chrome trace at ``path`` and the TRACE_BLOCK
    range's (start, end), the whole trace where it has none."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(ev["ts"], ev["ts"] + ev.get("dur", 0)) for ev in events
             if ev.get("name") == TRACE_BLOCK and ev.get("cat") == "user_annotation"]
    return events, (spans[0] if spans else (-float("inf"), float("inf")))


def kernel_launches(path: str) -> Tuple[int, List[float], int]:
    """Of the Chrome trace at ``path``: how many kernel launches inside the
    TRACE_BLOCK range (the whole trace where it has none) have no kernel
    event of the same correlation id; for each one that has, the kernel's
    start less its launch's, in microseconds; and how many launches before
    the range have no kernel event."""
    events, (t0, t1) = _block(path)
    launched = {ev["args"]["correlation"]: ev["ts"] for ev in events
                if ev.get("name") in _LAUNCH_CALLS and "correlation" in ev.get("args", {})}
    ran = {ev["args"].get("correlation"): ev["ts"] for ev in events
           if ev.get("cat") == "kernel" and "args" in ev}
    block = {c: ts for c, ts in launched.items() if t0 <= ts <= t1}
    return (sum(c not in ran for c in block),
            [ran[c] - ts for c, ts in block.items() if c in ran],
            sum(c not in ran for c, ts in launched.items() if ts < t0))


def block_device_events(path: str) -> List[Tuple[str, float]]:
    """(name, duration in microseconds) of each kernel, copy and memset
    event of the Chrome trace at ``path`` that a call inside the
    TRACE_BLOCK range (the whole trace where it has none) started."""
    events, (t0, t1) = _block(path)
    calls = {ev["args"]["correlation"] for ev in events
             if ev.get("cat") in ("cuda_runtime", "cuda_driver") and t0 <= ev["ts"] <= t1
             and "correlation" in ev.get("args", {})}
    return [(ev["name"], ev.get("dur", 0)) for ev in events
            if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and ev.get("args", {}).get("correlation") in calls]


@dataclasses.dataclass
class SpanStats:
    """What the calls of one span name took on the host's clock."""

    count: int
    total_s: float
    first_s: float


# span name -> its calls in this process
SPANS: Dict[str, SpanStats] = {}
# one row per epoch that the runner timed, in order: phase -> ms
PHASES: List[Dict[str, float]] = []
# one entry per row of PHASES: True where the epoch replayed CUDA graphs
EPOCH_REPLAYED: List[bool] = []


class span:
    """``with span(name):`` adds the block's host seconds to ``SPANS[name]``.
    Inside a profiler session the block is also a ``record_function``
    range; outside one it costs a flag test and two clock reads."""

    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        stats = SPANS.get(self.name)
        if stats is None:
            SPANS[self.name] = SpanStats(1, dt, dt)
        else:
            stats.count += 1
            stats.total_s += dt
        return False


def reset() -> None:
    """Empty ``SPANS``, ``PHASES`` and ``EPOCH_REPLAYED`` (in place)."""
    SPANS.clear()
    PHASES.clear()
    EPOCH_REPLAYED.clear()


def summary() -> str:
    """A table of ``SPANS``, the mean of each phase over ``PHASES`` and how
    many of those epochs replayed CUDA graphs."""
    lines = [f"{'span':<36}{'calls':>8}{'total s':>12}{'first ms':>12}{'mean ms':>12}"]
    for name, s in sorted(SPANS.items()):
        lines.append(f"{name:<36}{s.count:>8}{s.total_s:>12.4f}{s.first_s * 1e3:>12.3f}"
                     f"{s.total_s / s.count * 1e3:>12.3f}")
    if PHASES:
        means = {k: sum(row[k] for row in PHASES) / len(PHASES) for k in PHASES[0]}
        lines.append(f"epoch phases, mean ms over {len(PHASES)} epochs: "
                     + ", ".join(f"{k} {v:.3f}" for k, v in means.items())
                     + f"; epoch {sum(means.values()):.3f}; "
                     f"{sum(EPOCH_REPLAYED)} replayed from CUDA graphs")
    return "\n".join(lines)
