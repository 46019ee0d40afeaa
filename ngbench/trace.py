"""The device trace of a ``--trace 1`` run and what the harness reads from
it: device events, busy time, idle gaps and the breakdown.

The window is traced with ``torch.profiler`` recording CUDA activity only
(kernels, copies, fills), so the host's own ops add no events. Events are
read from the profiler's raw kineto records, whose timestamps are
``CLOCK_REALTIME`` nanoseconds, the clock of ``time.time_ns()``: the
harness marks its own host spans on that clock, and each idle gap of the
device is named by the host span it began in.

``union_s`` is frozen from ``chip_smoke.py``'s ``union_ms``: busy time is
the union of the device events, overlapping work counted once.
"""
from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

# the port's hand-written kernels, by the name their __global__ carries
PORT_KERNELS = ("field_fwd", "mlp_fwd", "composite_fwd", "encode_fwd",
                "encode_bwd")
_PORT = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")_kernel\b")
# range names the program's profiler annotations (obs.trace.annotate) give:
# their device-side mirrors span work and gaps, and are not device work
_ANNOTATIONS = {"encode", "mlp", "encode_mlp", "raymarch", "compact",
                "composite", "host"}

Event = Tuple[str, int, int]          # (name, start ns, end ns)


def port_kernel(name: str) -> Optional[str]:
    """Which of the port's kernels a device event is, or None."""
    m = _PORT.search(name)
    return m.group(1) if m else None


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return re.sub(r"^void ", "", name)[-90:]


def union_s(spans: Sequence[Tuple[int, int]]) -> float:
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or e > end:
            busy += e - (s if end is None else max(s, end))
            end = e
    return busy / 1e9


def idle_gaps(spans: Sequence[Tuple[int, int]], w0: int, w1: int
              ) -> List[Tuple[int, int]]:
    """The intervals of [w0, w1] in which no device event ran."""
    gaps, cur = [], w0
    for s, e in sorted(spans):
        if s > cur:
            gaps.append((cur, min(s, w1)))
        cur = max(cur, e)
        if cur >= w1:
            break
    if cur < w1:
        gaps.append((cur, w1))
    return [(a, b) for a, b in gaps if b > a]


def span_at(spans: Sequence[Tuple[str, int, int]], t: int) -> str:
    """The label of the last host span that began at or before ``t`` and
    had not ended by then; "harness" between spans."""
    starts = [s[1] for s in spans]
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        label, a, b = spans[i]
        if a <= t < b:
            return label
        if b <= t:
            break
        i -= 1
    return "harness"


def breakdown(events: Sequence[Event], host_spans, w0: int, w1: int,
              top: int = 10) -> Dict[str, list]:
    """The device operations that took most time and the longest idle
    gaps, each named by what the harness was doing on the host when it
    began: ``{"device_ops": [[name, s]], "idle_gaps": [[name, s]]}``."""
    by_raw: Dict[str, int] = {}
    for name, s, e in events:
        by_raw[name] = by_raw.get(name, 0) + (e - s)
    by_name: Dict[str, int] = {}
    for name, t in by_raw.items():
        key = short_name(name)
        by_name[key] = by_name.get(key, 0) + t
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(host_spans, key=lambda s: s[1])
    gaps = sorted(idle_gaps([(s, e) for _, s, e in events], w0, w1),
                  key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[span_at(host, a), (b - a) / 1e9]
                          for a, b in gaps]}


class DeviceTrace:
    """``torch.profiler`` over CUDA activity, from ``start`` to ``stop``."""

    def __init__(self):
        self._prof = None
        self.w0 = self.w1 = 0
        self.events: List[Event] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.w0 = time.time_ns()

    def stop(self) -> None:
        """Wait for the device, end the trace and keep its device events,
        sorted by start."""
        import torch
        torch.cuda.synchronize()
        self.w1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != cuda or ev.is_user_annotation():
                continue
            name = ev.name()
            if name in _ANNOTATIONS:
                continue
            s = ev.start_ns()
            out.append((name, s, s + ev.duration_ns()))
        self._prof = None
        self.events = sorted(out, key=lambda e: e[1])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.events])

    def kernel_events(self, kernel: str) -> List[Event]:
        names = {n for n in {e[0] for e in self.events}
                 if port_kernel(n) == kernel}
        return [e for e in self.events if e[0] in names]
