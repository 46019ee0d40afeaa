"""The readings the limits of a cell's check are set from, on the card.

    python3 ngbench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 4]

For each seed of ``--seeds`` it builds the cell as a run does (its kind
module's ``readings``: a short window at the cell's own load, or a
training cell's first steps), and prints the numbers the check compares
for the program (the lower readings). For each seed of
``--control-seeds`` it prints the same numbers for the control: the
reference put in the program's place with its matrix products in TF32
(``reference/field.tf32``), the next precision below the configuration's
f32; for a training cell also for the planted fault of half of each
batch's rays left out, the loss their mean. One JSON line a reading, with
``correct``: the reading judged by the harness's own check against the
cell's limits (``bench.limits``, ``bench.passes``). The benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ngbench import spec                                   # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def readings(cell, seed, dev, program, seconds, control, here=spec.HERE):
    """(side, numbers, correct, notes) of one seed: the program's and, with
    ``control``, the control's and the planted faults'."""
    from ngbench import bench
    cell_run = spec.kind(cell, here).make(cell, seed, dev, program, here)
    for side, numbers, notes in cell_run.readings(seconds, control):
        ok = bench.passes(bench.limits(cell, numbers, {}))
        yield side, numbers, ok, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cell = spec.find_cell(args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from ngbench import program
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        for side, numbers, ok, notes in readings(
                cell, seed, dev, program, args.seconds, seed in controls):
            emit({"seed": seed, "side": side, "correct": ok, **notes,
                  **numbers})
        print(f"[control] seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
