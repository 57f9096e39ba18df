"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3 [--plants-on 3]
        [--out FILE]

In one process, for each seed: the cell's inputs and the port's runner built
once; a round's first steps of the sound program, and on the first
``--plants-on`` seeds also of the control and of each fault that a run can
show (``program.plant``; a state left unchanged reads 1 and needs no run);
then, the program freed, the reference once and every snapshot's compared
numbers.  One JSON line per seed and variant, to standard output and to
``--out``.  It needs a card, like ``run.py``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHIP_PLANTS = ("control", "half_batch", "answer")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--plants-on", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from gpubench.harness import free, load_cell, reference_readings
    from gpubench.inputs import make_inputs
    from gpubench.program import Program, plant

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            inputs = make_inputs(cell.config, cell.traffic, seed, device)
            program = Program(cell.config, cell.traffic, inputs, device)
            snaps = {}
            for name in (None, *(CHIP_PLANTS if i < args.plants_on else ())):
                with plant(name):
                    program.reset_round()
                    snaps[name or "sound"] = program.first_steps(cell.traffic["check_steps"])
            build_s = program.graph_build_s
            del program, inputs
            free(device)
            t1 = time.perf_counter()
            readings = reference_readings(cell, seed, snaps, device)
            t2 = time.perf_counter()
            for name, values in readings.items():
                line = json.dumps({"cell": cell.name, "seed": seed, "variant": name,
                                   "readings": values, "graph_build_s": build_s,
                                   "program_s": t1 - t0, "reference_s": t2 - t1})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            free(device)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
