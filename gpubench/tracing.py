"""A profiler session over a block of the run, and what the device did in it.

The session keeps the logic of the port's ``utils/profiling.py: trace`` in a
copy of its own, so that the yardstick does not move when the program's
profiling changes: 64 tiny warm-up launches (the first kernels of a session
can leave no event), a margin of 0.1 s before the block and after it, the
card synchronised, and the block marked by a range of its own, so that only
the device work that calls inside the range started is read.  The Chrome
trace goes to a temporary directory (under ``TMPDIR``) and is deleted once
read.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Tuple

import torch

WARMUP_LAUNCHES = 64
MARGIN_S = 0.1
BLOCK = "gpubench traced block"
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx"))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
# How far back the gap labelling looks for a host event that covers a gap.
LABEL_LOOKBACK = 512
TOP = 10


@dataclasses.dataclass
class Trace:
    """The device events that the block's calls started, in microseconds."""

    kernels: List[Tuple[str, float, float]]     # (name, start, duration)
    window: Tuple[float, float]                 # the block's (start, end)
    gaps: List[Tuple[str, float]]               # (host activity, idle microseconds)
    lost: int                                   # launches without a device event

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        """The union of the device events' intervals inside the window."""
        return sum(b - a for a, b in busy_intervals(self.kernels, self.window)) / 1e6

    def device_ops(self) -> List[List]:
        totals: Dict[str, float] = {}
        for name, _, dur in self.kernels:
            totals[name] = totals.get(name, 0.0) + dur / 1e6
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        totals: Dict[str, float] = {}
        for label, us in self.gaps:
            totals[label] = totals.get(label, 0.0) + us / 1e6
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def busy_intervals(kernels, window) -> List[Tuple[float, float]]:
    t0, t1 = window
    spans = sorted((max(ts, t0), min(ts + dur, t1)) for _, ts, dur in kernels)
    merged: List[List[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _label_gaps(busy, window, host) -> List[Tuple[str, float]]:
    """Each idle gap of the window with the innermost host event that covers
    its middle (the latest-starting one)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    edges = [window[0], *[x for ab in busy for x in ab], window[1]]
    out = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = "(no host event)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - LABEL_LOOKBACK, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        out.append((label, b - a))
    return out


def read_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    blocks = [(ev["ts"], ev["ts"] + ev.get("dur", 0)) for ev in events
              if ev.get("name") == BLOCK and ev.get("cat") == "user_annotation"]
    if not blocks:
        raise RuntimeError(f"{path}: the traced block's range is missing")
    t0, t1 = blocks[0]
    calls = {ev["args"]["correlation"]: ev.get("name") for ev in events
             if ev.get("cat") in ("cuda_runtime", "cuda_driver") and t0 <= ev["ts"] <= t1
             and "correlation" in ev.get("args", {})}
    kernels = [(ev["name"], float(ev["ts"]), float(ev.get("dur", 0))) for ev in events
               if ev.get("cat") in DEVICE_CATS
               and ev.get("args", {}).get("correlation") in calls]
    ran = {ev["args"].get("correlation") for ev in events
           if ev.get("cat") == "kernel" and "args" in ev}
    lost = sum(1 for c, name in calls.items() if name in LAUNCH_CALLS and c not in ran)
    host = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)), ev["name"])
            for ev in events if ev.get("cat") in HOST_CATS and ev.get("name") != BLOCK
            and ev.get("ph") == "X"]
    busy = busy_intervals(kernels, (t0, t1))
    return Trace(kernels=kernels, window=(t0, t1), gaps=_label_gaps(busy, (t0, t1), host),
                 lost=lost)


@contextlib.contextmanager
def traced():
    """Profile the block (host and card); afterwards ``holder["trace"]`` is
    its ``Trace``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = {}
    with tempfile.TemporaryDirectory(prefix="gpubench_trace_") as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                w.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
            with record_function(BLOCK):
                yield holder
                torch.cuda.synchronize()
            time.sleep(MARGIN_S)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = read_trace(path)
    if not trace.kernels:
        raise RuntimeError("the traced block ran no device operation that the trace holds")
    if trace.lost:
        print(f"trace: {trace.lost} kernel launches of the block have no kernel event; "
              "the device times undercount", file=sys.stderr)
    holder["trace"] = trace
