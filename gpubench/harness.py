"""One run of one cell: set-up, the timed window, the traced tail, the check.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is found by its name from ``BENCHMARK.json``:
``configs/<config>.json`` (by the entry's ``file``), ``kinds/<kind>.py`` for
each of its layers (``reference.model.load_kind``), ``traffic/<mix>.json``,
``metrics/<metric>.py`` (a ``read(ctx)`` that returns the value, or None
where the run holds nothing to read) and ``limits/<cell>.json``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checks, counts
from .inputs import make_inputs
from .program import Program, Snapshot, plant, sync
from .reference.metrics import metric_rows
from .reference.model import PlainGraph, agg_dtype, train_steps

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the workloads entry of BENCHMARK.json
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[entry["config"]]["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = read_json(BENCH_DIR / "limits" / f"{name}.json")
    checks.check_limits(limits, name)
    return Cell(name=name, entry=entry, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _for_cell(m, name)],
                per_layer=[m for m in bench["per_layer"] if _for_cell(m, name)])


def load_reader(name: str):
    """The module of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader may read."""

    trace: object                  # tracing.Trace of the traced stretches
    traced_epochs: int
    epoch_ms: List[float]          # the runner's epoch_ms over the window
    wall_per_epoch_s: float        # the untraced window's wall time an epoch
    flops_per_epoch: float
    agg_bytes_per_epoch: int
    peaks: Optional[dict]
    graph_build_s: float

    def reader(self, name: str):
        return load_reader(name)

    def kernel_ms(self, patterns) -> float:
        """Device ms per traced epoch of the operations whose name holds one
        of ``patterns`` (case-insensitive); every operation for ()."""
        us = sum(dur for name, _, dur in self.trace.kernels
                 if not patterns or any(p in name.lower() for p in patterns))
        return us / 1e3 / self.traced_epochs


@dataclasses.dataclass
class Window:
    seconds: float
    epochs: int
    fold_epochs: int
    epoch_ms: List[float]
    nonfinite: int                 # epochs with a training loss that is not finite
    peak_bytes: int
    launches: Optional[Dict[str, int]]   # the port's launch counters over it (a card's)
    message_dtype: str             # the port's aggregation dtype at its close


def timed_window(program: Program, seconds: float, folds: int) -> Window:
    """Whole stretches until ``seconds`` have passed; the window ends with
    the stretch that is running then, and a synchronize."""
    cuda = program.device.type == "cuda"
    sync(program.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(program.device)
    before = program.launches()
    t0 = time.perf_counter()
    epochs, nonfinite, epoch_ms = 0, 0, []
    while True:
        n = program.next_stretch()
        _, hist, ms = program.epochs(n)
        epochs += n
        epoch_ms += ms
        nonfinite += int((~np.isfinite(hist["train"]["loss"])).any(0).sum())
        if time.perf_counter() - t0 >= seconds:
            break
    sync(program.device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(program.device) if cuda else 0
    launches = ({k: v - before[k] for k, v in program.launches().items()} if cuda
                else None)
    return Window(seconds=wall, epochs=epochs, fold_epochs=folds * epochs, epoch_ms=epoch_ms,
                  nonfinite=nonfinite, peak_bytes=peak, launches=launches,
                  message_dtype=program.message_dtype())


def traced_tail(program: Program, stretches: int):
    """(Trace, epochs) of ``stretches`` more stretches under the profiler."""
    from .tracing import traced

    epochs = 0
    with traced() as holder:
        for _ in range(stretches):
            n = program.next_stretch()
            program.epochs(n)
            epochs += n
    return holder["trace"], epochs


def reference_readings(cell: Cell, seed: int, snaps: Dict[str, Snapshot],
                       device) -> Dict[str, Dict[str, float]]:
    """The compared numbers of each snapshot: the reference makes the inputs
    again from the seed and follows the snapshots' steps."""
    config, traffic = cell.config, cell.traffic
    ref_in = make_inputs(config, traffic, seed, device)
    n = ref_in.n
    graph = PlainGraph.build(ref_in.src, ref_in.dst, n, traffic["self_loops"])
    steps = train_steps(config, graph, ref_in.feats[:n], ref_in.labels[:n],
                        ref_in.train_masks[:, :n], ref_in.weights, traffic["check_steps"])
    theta0 = {k: v.cpu() for k, v in ref_in.weights.items()}
    labels = ref_in.labels[:n].cpu()
    train_m, val_m = ref_in.train_masks[:, :n].cpu(), ref_in.val_masks[:, :n].cpu()
    del graph, ref_in
    out = {}
    for name, snap in snaps.items():
        rows = metric_rows(snap.probs, labels, train_m, val_m, config["alpha"],
                           traffic["auc_every"], config["epoch_num"])
        out[name] = checks.readings(snap, steps, rows, theta0)
    return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             fault: Optional[str] = None) -> dict:
    """One run: the result line's fields but ``device``'s name and count."""
    config, traffic = cell.config, cell.traffic
    folds = traffic["fold_batch"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    marks = [("start", time.perf_counter())]
    inputs = make_inputs(config, traffic, seed, device)
    shape = counts.graph_shape(inputs.n, inputs.dst, traffic["self_loops"])
    sync(device)
    marks.append(("inputs", time.perf_counter()))
    with plant(fault):
        program = Program(config, traffic, inputs, device)
        if cuda and fault is None and torch.backends.cuda.matmul.allow_tf32 != config["tf32"]:
            raise RuntimeError("the port runs matmuls in another precision than the "
                               "configuration states")
        marks.append(("program", time.perf_counter()))
        snap = program.first_steps(traffic["check_steps"])
        marks.append(("checked steps", time.perf_counter()))
        if program.epoch % traffic["stretch_epochs"]:
            program.epochs(program.next_stretch())       # the rest of the first stretch
        sync(device)
        marks.append(("first stretch", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        print(f"set-up {setup_s:.3f} s: before the cell {marks[0][1] - t_start:.3f}, "
              + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
              + f" (graph build {program.graph_build_s:.3f}, hub {program.hub})",
              file=sys.stderr)
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        win = timed_window(program, seconds, folds)
        tail = traced_tail(program, traffic["trace_stretches"]) if trace else None
    graph_build_s = program.graph_build_s
    del program, inputs
    free(device)

    t_ref = time.perf_counter()
    values = reference_readings(cell, seed, {"run": snap}, device)["run"]
    print(f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    values["agg_dtype_off"] = checks.dtype_off(config.get("agg_dtype", "float32"),
                                               win.message_dtype, win.launches)
    correct, compared = checks.judge(values, cell.limits)

    e2e = {"fold_epochs_per_s": win.fold_epochs / win.seconds,
           "peak_mem_gib": win.peak_bytes / 2**30, "setup_s": setup_s}
    result = {"correct": correct, "attempted": win.epochs, "failed": win.nonfinite,
              "memory_peak_bytes": max(setup_peak, win.peak_bytes), "checks": compared}
    if tail is None:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        return result
    trace_, traced_epochs = tail
    ctx = MetricContext(
        trace=trace_, traced_epochs=traced_epochs, epoch_ms=win.epoch_ms,
        wall_per_epoch_s=win.seconds / win.epochs,
        flops_per_epoch=counts.dense_flops_per_epoch(config, shape.n, folds),
        agg_bytes_per_epoch=counts.aggregation_bytes_per_epoch(
            config, shape, folds, torch.finfo(agg_dtype(config)).bits // 8),
        peaks=counts.peaks(torch.cuda.get_device_name(device)) if cuda else None,
        graph_build_s=graph_build_s)
    metrics = {}
    for m in cell.per_layer:
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result.update(metrics=metrics, busy_s=trace_.busy_s, window_s=trace_.window_s,
                  breakdown={"device_ops": trace_.device_ops(),
                             "idle_gaps": trace_.idle_gaps()})
    return result
