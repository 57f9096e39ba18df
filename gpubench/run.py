"""Run one cell of BENCHMARK.json once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted`` (epochs of the window), ``failed`` (epochs
whose training loss is not finite), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` also ``breakdown``, then ``card`` (name and power limit) and,
last, ``checks``: each compared number with its limit.  The same numbers are
the last lines of standard error.  The run fails, printing no result, without
as many cards as the cell asks for, and if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names that no run may load (the port's own name starts
# with the JAX package's, so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "plagnn_tpu")


def set_cache_dirs() -> None:
    """The program's build and kernel caches at fixed paths in the checkout
    (the port builds its CUDA libraries into ``plagnn_tpu_torch/_build``)."""
    base = ROOT / "gpubench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def plain_number(v):
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_dirs()
    sys.path[0] = str(ROOT)        # the checkout, in place of this script's folder
    import torch

    from gpubench.harness import load_cell, run_cell

    cell = load_cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}: no run may load JAX or the JAX package",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
        line["breakdown"] = res["breakdown"]
    line["card"] = card_line()
    line["checks"] = {k: {"value": plain_number(c["value"]), "limit": c["limit"]}
                      for k, c in res["checks"].items()}
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
