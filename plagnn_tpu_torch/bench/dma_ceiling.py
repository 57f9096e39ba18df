"""Random-row gather ceiling of the card: a compute-free probe.

Port of ``benchmarks/dma_ceiling.py``.  The max kernels gather rows of x
(or of g and its argmax) by source id, and the rate at which the card can
fetch randomly addressed rows of a given width, with nothing else to do, is
the yardstick their times are read against.

* ``dma_ring(x, idx, ng, g)`` fetches ``idx``'s rows of an f32 table window
  by window (``T_E`` ids a window), in groups of ``g`` rows on an ``ng``-deep
  ring of slots, and returns the rows slot 0 holds at the end: group
  ``((T_E // g - 1) // ng) * ng`` of the last window.  A CUDA tensor launches
  ``csrc/dma_ceiling.cu`` (TMA bulk copies into shared memory, one mbarrier
  a slot); a CPU tensor takes ``dma_ring_plain``.  ``LAUNCHES`` counts the
  kernel's launches.
* ``build_bench`` makes a table and its ids: with numpy in the JAX
  ``build_bench``'s order (so at a multiple of 4 KB the table is JAX's
  reshaped to rows and the ids are JAX's), or on the card from a
  ``torch.Generator`` for the timing tables.  It cuts ``g`` to the largest
  power of two whose ring fits a block's 227 KB of shared memory.
* ``measure`` times one point by CUDA events, many launches a repetition
  after a warm-up, the median of ``reps`` with their spread (under ``-d cpu``
  the plain version by the host clock, labelled so).  ``main`` sweeps row
  widths, ring depths, table sizes and orders into a JSON file.
* ``load_achievable_rate`` reads such a file (the port's, or the JAX
  package's) back as a row_bytes -> bytes/s interpolator.

The rate is a service rate, the bytes fetched over the time: a table that
fits the L2 is served from there after its first touch, so it can pass the
HBM's 3.35 TB/s.  It is not a roofline share.

    python -m plagnn_tpu_torch.bench.dma_ceiling                 # on the card
    python -m plagnn_tpu_torch.bench.dma_ceiling -d cpu --rows-bytes 256 1024 \\
        --n-rows 256 --target-mb 1 --reps 2 --depth-sweep          # plain, host clock

The file goes to ``--out`` (default ``chiprun_out/dma_ceiling.json`` in the
checkout); one JSON line goes to stdout.
"""
from __future__ import annotations

import argparse
import bisect
import ctypes
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build

T_E = 1024   # ids a window (the production kernels' index chunk)
G = 8        # rows a ring slot, where the ring fits
SMEM_BYTES = 232448        # shared memory one block can take (227 KB)
ID_BYTES = 2 * T_E * 4     # the ids' double buffer
MAX_RING = 64              # the kernel keeps a phase bit a slot in 64 bits
MAX_GROUP = 32             # one lane issues each row of a slot
L2_BYTES = 50 * 2**20      # the H100's L2
SEED = 70
TARGET_MB = 1024           # bytes fetched a timed launch, default
REPS = 10
REP_MS = 2.0               # a timed repetition repeats launches to last this long
MAX_LAUNCHES = 64
ACHIEVABLE_DEPTH = 8       # the ring depth whose random points the reader takes
DEFAULT_N_ROWS = 24064     # the 24k-node PPI's padded rows
ENV = "PLAGNN_TORCH_DMA_CEILING"
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "dma_ceiling.json"
LAUNCHES: Dict[str, int] = {"dma_ring_f32": 0}

# (row_bytes, ng, g, windows) the card checks the kernel against its plain
# version at (tests/test_torch_cuda.py, chip_smoke.py): every ring form the
# sweep takes, window counts past the grid and not a multiple of it (blocks
# an SM, by the occupancy calculator on the H100, x 132 SMs: 9 at 256 B x 8
# x 8, 5 at 512 B x 16 x 4 and 1 KB x 4 x 8, 3 at 4 KB x 2 x 8, 1 from 128
# KB of ring up, 24 at 16 B x 1 x 1), and a few windows.
CHECK_SHAPES = (
    (256, 8, 8, 1),
    (256, 8, 8, 1250),
    (512, 16, 4, 1500),
    (1024, 4, 8, 700),
    (4096, 2, 8, 5),
    (4096, 8, 4, 140),
    (20480, 8, 1, 300),
    (24576, 8, 1, 133),
    (65536, 3, 1, 134),
    (16, 1, 1, 3),
)
CHECK_ROWS = 3000

# Gathered bytes the plain version holds at once.
_PLAIN_BYTES = 1 << 26

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# x, idx, pitch, row_bytes, n_fetch, ng, g, out, stream
_ARGTYPES = [_P, _P, _LL, _I, _LL, _I, _I, _P, _P]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("dma_ceiling")
    lib.dma_ring_f32.argtypes = _ARGTYPES
    lib.dma_ring_f32.restype = ctypes.c_int
    lib.dma_ring_blocks.argtypes = [_I, _I, _I, ctypes.POINTER(_LL)]
    lib.dma_ring_blocks.restype = ctypes.c_int
    return lib


def ring_bytes(row_bytes: int, ng: int, g: int) -> int:
    """Shared memory of one block: the ring, the ids' double buffer and
    ng + 2 barriers."""
    return ng * g * row_bytes + ID_BYTES + 8 * (ng + 2)


def ring_group(row_bytes: int, ng: int, g: int = G) -> int:
    """The largest power of two <= ``g`` whose ring of ``ng`` slots fits a
    block's shared memory; raises where one row a slot does not fit."""
    if ring_bytes(row_bytes, ng, 1) > SMEM_BYTES:
        raise ValueError(f"a ring of {ng} slots of {row_bytes} B rows needs "
                         f"{ring_bytes(row_bytes, ng, 1)} B of shared memory "
                         f"at one row a slot, more than {SMEM_BYTES}")
    while g > 1 and (g & (g - 1) or ring_bytes(row_bytes, ng, g) > SMEM_BYTES):
        g -= 1
    return g


def grid_blocks(row_bytes: int, ng: int, g: int, device) -> int:
    """The most blocks a launch of this ring runs on ``device``'s card
    (blocks an SM as shared memory allows, by the occupancy calculator, x
    SMs); 1 on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    blocks = _LL(0)
    with torch.cuda.device(device):
        rc = _lib().dma_ring_blocks(row_bytes, ng, g, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"dma_ring_blocks failed: CUDA error {rc}")
    return blocks.value


def sweep_fetch(row_bytes: int, ng: int, target_mb: int, device) -> int:
    """Ids a timed launch fetches: ``max(target_mb MiB / row_bytes, 4 T_E)``
    rounded up to whole waves of the grid's windows (``grid_blocks`` x T_E),
    so that every block takes as many windows as the others."""
    wave = grid_blocks(row_bytes, ng, ring_group(row_bytes, ng), device) * T_E
    n_fetch = max(target_mb * 2**20 // row_bytes, 4 * T_E)
    return -(-n_fetch // wave) * wave


def _check(x: torch.Tensor, idx: torch.Tensor, ng: int, g: int) -> None:
    """Raises on what the kernel does not take (the ids' range apart:
    ``_check_ids``)."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"x must be a 2-D float32 table with unit column stride, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    row_bytes, pitch = x.shape[1] * 4, x.stride(0) * 4
    if row_bytes == 0 or row_bytes % 16 or pitch % 16:
        raise ValueError(f"x's rows ({row_bytes} B) and pitch ({pitch} B) must be "
                         "nonzero multiples of 16 bytes")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous 1-D int32 tensor, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.numel() == 0 or idx.numel() % T_E:
        raise ValueError(f"n_fetch ({idx.numel()}) must be a positive multiple of T_E = {T_E}")
    if idx.device != x.device:
        raise ValueError(f"idx on {idx.device}, x on {x.device}")
    if not 1 <= g <= MAX_GROUP or T_E % g:
        raise ValueError(f"g ({g}) must divide T_E = {T_E} and lie in 1 .. {MAX_GROUP}")
    if not 1 <= ng <= MAX_RING:
        raise ValueError(f"ng ({ng}) must lie in 1 .. {MAX_RING}")
    if ring_bytes(row_bytes, ng, g) > SMEM_BYTES:
        raise ValueError(f"a ring of {ng} x {g} rows of {row_bytes} B needs "
                         f"{ring_bytes(row_bytes, ng, g)} B of shared memory, "
                         f"more than {SMEM_BYTES}")
    if x.device.type == "cuda" and (x.data_ptr() % 16 or idx.data_ptr() % 16):
        raise ValueError("x and idx must be 16-byte aligned")


def _check_ids(x: torch.Tensor, idx: torch.Tensor) -> None:
    """Raises where an id lies outside x's rows (one host sync)."""
    if bool(((idx < 0) | (idx >= x.shape[0])).any()):
        raise ValueError(f"ids must lie in [0, {x.shape[0]})")


def dma_ring_plain(x: torch.Tensor, idx: torch.Tensor, ng: int, g: int = G) -> torch.Tensor:
    """Plain PyTorch version: every fetched row gathered by indexing, window
    by window (windows batched up to 64 MB of rows), and slot 0's last group
    of the last window returned, (g, row_elems)."""
    n_groups = T_E // g
    last0 = (n_groups - 1) // ng * ng
    windows = idx.numel() // T_E
    per = max(1, _PLAIN_BYTES // (T_E * x.shape[1] * 4))
    slot0 = None
    for w0 in range(0, windows, per):
        w1 = min(windows, w0 + per)
        rows = x.index_select(0, idx[w0 * T_E:w1 * T_E].long())
        slot0 = rows.view(w1 - w0, n_groups, g, x.shape[1])[-1, last0]
    return slot0.clone()


def _launch(x: torch.Tensor, idx: torch.Tensor, ng: int, g: int,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the kernel on checked inputs."""
    lib = _lib()
    if out is None:
        out = torch.empty((g, x.shape[1]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.dma_ring_f32(x.data_ptr(), idx.data_ptr(), x.stride(0) * 4, x.shape[1] * 4,
                              idx.numel(), ng, g, out.data_ptr(),
                              ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"dma_ring_f32 launch failed: CUDA error {rc}")
    LAUNCHES["dma_ring_f32"] += 1
    return out


def dma_ring(x: torch.Tensor, idx: torch.Tensor, ng: int, g: int = G) -> torch.Tensor:
    """Slot 0's rows after fetching ``idx``'s rows of ``x`` (f32 [n_rows,
    row_elems], row and pitch multiples of 16 bytes) through a ring of ``ng``
    slots of ``g`` rows; ``idx`` int32, a multiple of ``T_E`` ids.  CUDA
    tensors launch the kernel, CPU tensors take the plain version."""
    _check(x, idx, ng, g)
    _check_ids(x, idx)
    if x.device.type == "cpu":
        return dma_ring_plain(x, idx, ng, g)
    return _launch(x, idx, ng, g)


def build_bench(n_rows: int, row_bytes: int, n_fetch: int, ng: int, pattern: str,
                seed: int = SEED, device="cuda", rng: str = "numpy",
                ids: Optional[torch.Tensor] = None, g: Optional[int] = None):
    """(run, n_fetch, (idx, x, g)): a table of ``n_rows`` f32 rows of
    ``row_bytes``, ``n_fetch`` ids (rounded up to T_E) in ``pattern``
    ("random" or "sequential"), and ``run()``, one fetch of them all through
    ``dma_ring`` (inputs checked here once).  ``rng="numpy"`` draws the ids,
    then the table, from ``numpy.random.default_rng(seed)`` as the JAX
    ``build_bench`` does; ``rng="torch"`` from a ``torch.Generator`` on
    ``device``.  ``ids`` (int32) replace the pattern's, padded to T_E by
    repeating their start.  ``g`` defaults to ``ring_group(row_bytes, ng)``."""
    if row_bytes <= 0 or row_bytes % 16:
        raise ValueError(f"row_bytes ({row_bytes}) must be a positive multiple of 16")
    device = torch.device(device)
    g = ring_group(row_bytes, ng) if g is None else g
    elems = row_bytes // 4
    if ids is not None:
        n_fetch = -(-ids.numel() // T_E) * T_E
        pad = n_fetch - ids.numel()
        idx = torch.cat([ids, ids[torch.arange(pad, device=ids.device) % ids.numel()]])
        idx = idx.to(device, torch.int32).contiguous()
    n_fetch = -(-n_fetch // T_E) * T_E
    if rng == "numpy":
        gen = np.random.default_rng(seed)
        if ids is None:
            if pattern == "random":
                idx = gen.integers(0, n_rows, n_fetch).astype(np.int32)
            else:
                idx = (np.arange(n_fetch, dtype=np.int64) % n_rows).astype(np.int32)
            idx = torch.from_numpy(idx).to(device)
        x = torch.from_numpy(gen.random((n_rows, elems), np.float32)).to(device)
    elif rng == "torch":
        gen = torch.Generator(device=device).manual_seed(seed)
        if ids is None:
            if pattern == "random":
                idx = torch.randint(0, n_rows, (n_fetch,), generator=gen, device=device,
                                    dtype=torch.int32)
            else:
                idx = (torch.arange(n_fetch, device=device) % n_rows).to(torch.int32)
        x = torch.rand((n_rows, elems), generator=gen, device=device)
    else:
        raise ValueError(f"rng must be 'numpy' or 'torch', got {rng!r}")
    _check(x, idx, ng, g)
    _check_ids(x, idx)
    if device.type == "cpu":
        def run():
            return dma_ring_plain(x, idx, ng, g)
    else:
        out = torch.empty((g, elems), dtype=torch.float32, device=device)

        def run():
            return _launch(x, idx, ng, g, out)
    return run, n_fetch, (idx, x, g)


def time_launches(run, reps: int, device) -> Tuple[List[float], int]:
    """(ms a launch in each of ``reps`` repetitions, launches a repetition).
    On the card: CUDA events around as many launches as fill REP_MS (at most
    MAX_LAUNCHES), after a warm-up launch; on the CPU: the host clock around
    one call."""
    device = torch.device(device)
    run()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        return times, 1
    torch.cuda.synchronize(device)

    def timed(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            run()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    n = max(1, min(MAX_LAUNCHES, math.ceil(REP_MS / max(timed(1), 1e-3))))
    return [timed(n) for _ in range(reps)], n


def measure(row_bytes: int, ng: int, pattern: str, n_rows: int,
            target_mb: int = TARGET_MB, reps: int = REPS, device="cuda", bench=None) -> Dict:
    """One point of the sweep: ``sweep_fetch`` ids in ``pattern`` over a
    table of ``n_rows`` rows (``bench``: a ``build_bench`` result to time in
    place of a new one), timed by ``time_launches``; the median's rate with
    the slowest and fastest repetitions' beside it."""
    device = torch.device(device)
    if bench is None:
        n_fetch = sweep_fetch(row_bytes, ng, target_mb, device)
        bench = build_bench(n_rows, row_bytes, n_fetch, ng, pattern, device=device, rng="torch")
    run, n_fetch, (_, x, g) = bench
    times, per_rep = time_launches(run, reps, device)
    ms = statistics.median(times)
    fetched = n_fetch * row_bytes
    rec = {
        "row_kb": row_bytes / 1024, "row_bytes": row_bytes, "ring_depth": ng, "g": g,
        "pattern": pattern, "n_rows": n_rows, "table_bytes": n_rows * row_bytes,
        "fits_l2": n_rows * row_bytes <= L2_BYTES,
        "gbps": fetched / ms / 1e6, "ns_per_row": ms * 1e6 / n_fetch, "n_fetch": n_fetch,
        "gbps_lo": fetched / max(times) / 1e6, "gbps_hi": fetched / min(times) / 1e6,
        "blocks": min(grid_blocks(row_bytes, ng, g, device), n_fetch // T_E),
        "ms": ms, "launches_per_rep": per_rep, "reps": reps,
        "timer": ("cuda events" if device.type == "cuda"
                  else "host clock, plain version on the CPU"),
    }
    cut = f" (g cut from {G})" if g < G else ""
    print(f"row {row_bytes:>6} B  ng {ng:>2}  g {g}{cut}  {n_rows:>7} rows  {pattern:>10}: "
          f"{rec['gbps']:9.1f} GB/s [{rec['gbps_lo']:.1f}, {rec['gbps_hi']:.1f}]  "
          f"{rec['ns_per_row']:7.2f} ns/row, {n_fetch} rows, {per_rep} launches x {reps}",
          file=sys.stderr, flush=True)
    return rec


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi prints them (the torch
    name where nvidia-smi fails), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    except OSError:
        pass
    return torch.cuda.get_device_name(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-bytes", nargs="+", type=int,
                    default=[256, 512, 1024, 20480, 4096, 8192, 12288, 16384, 24576,
                             32768, 49152, 65536],
                    help="row widths: the max kernels' K-slices, a whole layer-1 row "
                         "(10 x 503 f32 padded to 16 B multiples: 20,480), then the JAX "
                         "sweep's 4-64 KB; widths whose ring does not fit are skipped")
    ap.add_argument("--ring-depths", nargs="+", type=int, default=[ACHIEVABLE_DEPTH])
    ap.add_argument("--depth-sweep-row-bytes", type=int, default=1024,
                    help="extra ring-depth sweep (random) at this row width")
    ap.add_argument("--depth-sweep", nargs="*", type=int, default=[2, 4, 16, 32])
    ap.add_argument("--n-rows", nargs="+", type=int, default=[DEFAULT_N_ROWS],
                    help="table sizes (rows)")
    ap.add_argument("--target-mb", type=int, default=TARGET_MB,
                    help="MiB fetched a timed launch, at least (rounded up to whole "
                         "waves of the grid's windows)")
    ap.add_argument("--patterns", nargs="+", default=["random", "sequential"])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("-d", type=str, default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    from ..train.engine import resolve_device

    device = resolve_device(args.d)
    label = card_label(device)
    print(f"device: {label}", file=sys.stderr, flush=True)
    results = {"device": label,
               "timer": ("cuda events" if device.type == "cuda"
                         else "host clock, plain version on the CPU"),
               "n_rows": list(args.n_rows), "rate": "service rate: bytes fetched over "
               "time (not a roofline share)", "sweep": []}

    def point(row_bytes, ng, pattern, n_rows):
        try:
            ring_group(row_bytes, ng)
        except ValueError as e:
            print(f"skipped: {e}", file=sys.stderr, flush=True)
            return
        results["sweep"].append(measure(row_bytes, ng, pattern, n_rows, args.target_mb,
                                        args.reps, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for n_rows in args.n_rows:
        for pattern in args.patterns:
            for row_bytes in args.rows_bytes:
                for ng in args.ring_depths:
                    point(row_bytes, ng, pattern, n_rows)
        for ng in args.depth_sweep:
            if ng not in args.ring_depths:
                point(args.depth_sweep_row_bytes, ng, "random", n_rows)
    results["sweep"].sort(key=lambda r: (r["n_rows"], r["pattern"], r["row_bytes"],
                                         r["ring_depth"]))
    for pattern in ("random", "sequential"):
        got = [r["gbps"] for r in results["sweep"] if r["pattern"] == pattern]
        if got:
            results[f"peak_{pattern}_gbps"] = max(got)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(f"wrote {out}", file=sys.stderr, flush=True)
    print(json.dumps({"metric": "dma_random_row_gbps",
                      "value": results.get("peak_random_gbps"), "unit": "GB/s",
                      "device": label, "timer": results["timer"]}))
    return results


# Random rows at ring depth 8, by table rows: (row_bytes, GB/s of the
# median, the slowest and the fastest of 10 repetitions), from ``python -m
# plagnn_tpu_torch.bench.dma_ceiling --n-rows 24064 165000 330112`` (1 GiB
# a launch at least, CUDA events) on BAKED_DEVICE (nvidia-smi's name and
# power limit).  Widths from 32 KB up do not fit a ring of 8.
BAKED_DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"
BAKED_RATES: Dict[int, Tuple[Tuple[int, float, float, float], ...]] = {
    24064: (
        (256, 6055.4, 6044.1, 6093.2),
        (512, 7156.3, 7008.9, 7198.2),
        (1024, 7386.4, 7254.8, 7402.8),
        (4096, 4626.3, 4565.0, 4642.2),
        (8192, 3671.3, 3625.6, 3721.8),
        (12288, 3508.8, 3461.9, 3538.4),
        (16384, 3455.8, 3444.1, 3462.7),
        (20480, 3401.0, 3393.3, 3407.1),
        (24576, 3377.7, 3336.9, 3383.8),
    ),
    165000: (
        (256, 5856.9, 5842.8, 5876.5),
        (512, 4772.9, 4741.0, 4816.1),
        (1024, 3843.6, 3830.5, 3855.9),
        (4096, 3237.6, 2728.9, 3254.1),
        (8192, 3175.1, 3138.4, 3200.9),
        (12288, 3168.7, 3148.5, 3184.6),
        (16384, 3139.9, 3125.0, 3174.8),
        (20480, 3142.2, 3131.6, 3149.0),
        (24576, 3184.4, 3104.8, 3195.6),
    ),
    330112: (
        (256, 4546.3, 4529.5, 4552.3),
        (512, 3713.3, 3674.0, 3727.9),
        (1024, 3417.6, 3406.0, 3423.8),
        (4096, 2911.0, 2599.5, 3186.1),
        (8192, 3148.4, 3119.1, 3157.0),
        (12288, 3142.1, 3123.6, 3147.7),
        (16384, 3083.8, 2713.6, 3167.5),
        (20480, 3176.0, 3132.9, 3182.7),
        (24576, 3155.7, 2685.3, 3170.0),
    ),
}


@dataclasses.dataclass(frozen=True)
class AchievableRate:
    """row_bytes -> bytes/s by linear interpolation between measured widths,
    clamped at both ends; ``which`` "mid" (the median), "lo" or "hi" (the
    slowest and fastest repetitions; the median where a point has none)."""

    points: Tuple[Tuple[float, float, float, float], ...]
    source: str
    n_rows: Optional[int]
    device: str

    def __call__(self, row_bytes: float, which: str = "mid") -> float:
        col = {"mid": 1, "lo": 2, "hi": 3}[which]
        xs = [p[0] for p in self.points]
        ys = [p[col] for p in self.points]
        if row_bytes <= xs[0]:
            return ys[0]
        if row_bytes >= xs[-1]:
            return ys[-1]
        i = bisect.bisect_left(xs, row_bytes)
        t = (row_bytes - xs[i - 1]) / (xs[i] - xs[i - 1])
        return ys[i - 1] * (1 - t) + ys[i] * t


def _rate_from(data: Dict, n_rows: Optional[int], source: str) -> Optional[AchievableRate]:
    """The random, ring-depth-8 points of a sweep file (the port's records
    by ``row_bytes`` and their own ``n_rows``; JAX's by ``row_kb`` x 1024 and
    the file's ``n_rows``), of the table nearest ``n_rows`` (by ratio; the
    only one, or DEFAULT_N_ROWS's nearest, where ``n_rows`` is None).  None
    under two points."""
    file_rows = data.get("n_rows")
    file_rows = file_rows if isinstance(file_rows, int) else None
    tables: Dict[Optional[int], list] = {}
    for r in data["sweep"]:
        if r["pattern"] != "random" or r["ring_depth"] != ACHIEVABLE_DEPTH:
            continue
        width = r["row_bytes"] if "row_bytes" in r else r["row_kb"] * 1024
        tables.setdefault(r.get("n_rows", file_rows), []).append(
            (width, r["gbps"] * 1e9, r.get("gbps_lo", r["gbps"]) * 1e9,
             r.get("gbps_hi", r["gbps"]) * 1e9))
    if not tables:
        return None
    want = DEFAULT_N_ROWS if n_rows is None else n_rows
    rows = min(tables, key=lambda k: 0.0 if k is None else abs(math.log(k / want)))
    pts = tuple(sorted(tables[rows]))
    if len(pts) < 2:
        return None
    return AchievableRate(pts, source, rows, str(data.get("device", "")))


def _baked() -> Dict:
    return {"device": BAKED_DEVICE, "sweep": [
        {"row_bytes": w, "n_rows": rows, "pattern": "random", "ring_depth": ACHIEVABLE_DEPTH,
         "gbps": mid, "gbps_lo": lo, "gbps_hi": hi}
        for rows, pts in BAKED_RATES.items() for w, mid, lo, hi in pts]}


def load_achievable_rate(path: Optional[str] = None,
                         n_rows: Optional[int] = None) -> Optional[AchievableRate]:
    """The measured random-row rate as an ``AchievableRate``, from an
    explicit ``path``, else ``$PLAGNN_TORCH_DMA_CEILING``, else the baked
    constants (``BAKED_RATES``, measured on ``BAKED_DEVICE``); a missing or
    malformed file, or one with under two points, falls through to the next
    source.  ``n_rows`` picks the measured table nearest a caller's own.
    None where no source has two points."""
    if n_rows is not None and n_rows <= 0:
        raise ValueError(f"n_rows must be positive, got {n_rows}")
    for p in (path, os.environ.get(ENV)):
        if not p:
            continue
        try:
            with open(p) as f:
                rate = _rate_from(json.load(f), n_rows, p)
        except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError,
                AttributeError):
            continue
        if rate is not None:
            return rate
    return _rate_from(_baked(), n_rows, "baked")


if __name__ == "__main__":
    main()
