"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

``run_cell`` returns the result as a dict; ``ngbench/run.py`` prints it.
The cell's kind module (``kinds/<kind>.py``, found by the workload's
``kind``) builds, warms, serves or trains and judges the cell. With
``trace`` the window runs under the device trace and the result's metrics
are the cell's per-layer metrics (each read by its module under
``metrics/``); without, its end-to-end metrics.
"""
from __future__ import annotations

import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from ngbench import spec
from ngbench.trace import DeviceTrace, breakdown

# top-level module names a run may not hold once its window has closed:
# the JAX package and JAX itself, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The run has not the cards its cell asks for."""


def log(msg: str) -> None:
    print(f"[ngbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def card(device: torch.device) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def pick_device(cell: spec.Cell, device: Optional[str]) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    chips = cell.entry["chips"]
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{cell.name} needs {chips} cards, "
                       f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def limits(cell: spec.Cell, numbers: Dict[str, float], counts: Dict
           ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit: the workload's, and the
    counts that must be 0."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
              for k, lim in cell.workload["check"]["limits"].items()}
    for k, v in counts.items():
        checks[k] = {"value": v, "limit": 0}
    return checks


def passes(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: Optional[str] = None,
             here: Path = spec.HERE) -> Dict:
    cell = spec.find_cell(name, here)
    dev = pick_device(cell, device)
    if trace and dev.type != "cuda":
        raise NoDevice("a traced run reads the card's trace: it needs CUDA")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    e2e = spec.end_to_end(name, here)
    readers = spec.per_layer(name, here) if trace else {}
    from ngbench import program
    bench = spec.kind(cell, here).make(cell, seed, dev, program, here)
    bench.warm()
    setup_s = time.perf_counter() - t_start
    log(f"{name}: set-up {setup_s:.3f} s; window of {seconds} s")
    if dev.type == "cuda":
        # the window's peak: the program's state and working memory, not
        # the transients of making the inputs
        torch.cuda.reset_peak_memory_stats(dev)
    tr = DeviceTrace() if trace else None
    win = bench.window(seconds, tr)
    if trace:
        log(f"{name}: window closed, trace read "
            f"{time.perf_counter() - t_start - setup_s - seconds:.1f} s "
            f"after the deadline")
    device_info = card(dev)
    out = bench.finish(win, trace)
    values = {"setup_s": setup_s, **out["values"]}
    numbers = out["numbers"]
    checks = limits(cell, numbers, out["must_be_0"])
    correct = passes(checks)
    log(f"{name}: checked at {time.perf_counter() - t_start:.1f} s")
    if trace:
        metrics = {}
        run = SimpleNamespace(trace=tr, **out["run"])
        for mname, mod in readers.items():
            v = mod.read(run)
            if v is not None:
                metrics[mname] = {"value": v, "unit": mod.UNIT}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        if tr.events:
            log(f"{name}: {len(tr.events)} device events; the first began "
                f"{(tr.events[0][1] - tr.w0) / 1e6:.3f} ms after the "
                f"window, the last ended {(tr.w1 - tr.events[-1][2]) / 1e6:.3f}"
                f" ms before its end")
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e if m["name"] in values}
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or of the JAX package were "
                           f"loaded: {bad}")
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": metrics, "device": device_info,
              "card_power_limit": power_limit() if dev.type == "cuda"
              else "no card",
              "numbers": numbers}
    if trace:
        result["breakdown"] = breakdown(tr.events, bench.host_spans,
                                        tr.w0, tr.w1)
    result["checks"] = checks
    return result
