"""Runs one cell of the benchmark and prints its result line.

    python3 ngbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``;
with ``--trace 1`` also ``breakdown``; ``checks`` last: each compared
number with its limit). The compared numbers are also the last lines of
standard error. Without the cards the cell asks for, or with the program
missing, it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                       # noqa: E402
import json                                           # noqa: E402
import os                                             # noqa: E402
import sys                                            # noqa: E402
from pathlib import Path                              # noqa: E402

# one host thread for PyTorch's CPU ops: the harness drives the card from
# one thread, and a pool of spinning workers only takes cores from it
os.environ.setdefault("OMP_NUM_THREADS", "1")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    torch.set_num_threads(1)
    from ngbench import bench
    try:
        result = bench.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), T_START)
    except bench.NoDevice as e:
        print(f"ngbench: {e}", file=sys.stderr)
        return 2
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
