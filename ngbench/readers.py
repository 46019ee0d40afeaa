"""What the per-layer metrics' readers (``metrics/<name>.py``) share: the
roofline share of one of the port's kernels, the device's idle share and
the whole step's share of the card's peak, from a traced run.

A traced run (``bench.run_cell``) hands each reader a namespace with
``trace`` (``trace.DeviceTrace``: the window's device events), ``units``
(the tiles or steps run in the traced window), ``calls_per_unit`` (each
port kernel's calls a tile or step, as the algorithm makes them),
``call_work`` (the counted work of calls, by kernel and by the call's
index among the window's calls of that kernel) and ``compute_s`` (the
least time of the window's FLOPs). A reader that finds nothing to read
returns None, and the metric is left out of the line.
"""
from __future__ import annotations

from typing import Optional

from ngbench.peaks import least_time_s
from ngbench.trace import port_kernel


def roofline_pct(run, kernel: str) -> Optional[float]:
    """The counted least time of ``kernel``'s counted calls over their
    device time, in %. None when the window's calls of the kernel are not
    the count the algorithm makes (the k-th event is then not the k-th
    call), or when none was counted."""
    works = getattr(run, "call_work", {}).get(kernel)
    events = run.trace.kernel_events(kernel)
    if not works or not events:
        return None
    if len(events) != run.units * run.calls_per_unit.get(kernel, 0):
        return None
    least = device = 0.0
    for k, w in works.items():
        _, s, e = events[k]
        least += least_time_s(w)
        device += (e - s) / 1e9
    return 100.0 * least / device if device > 0 else None


def idle_pct(run) -> Optional[float]:
    w = run.trace.window_s
    return 100.0 * (1.0 - run.trace.busy_s() / w) if w > 0 else None


def mfu_pct(run) -> Optional[float]:
    w = run.trace.window_s
    return 100.0 * run.compute_s / w if w > 0 and run.compute_s else None


def plain_device_s(run) -> float:
    """Device time of every event that is not one of the port's kernels."""
    plain = {n for n in {e[0] for e in run.trace.events}
             if port_kernel(n) is None}
    return sum(e - s for name, s, e in run.trace.events
               if name in plain) / 1e9
