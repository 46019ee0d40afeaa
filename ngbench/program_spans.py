"""The program's own spans in a traced run, on the device trace's clock.

The port's tracer (``repro_torch.obs.trace.TRACER``) records host spans
and device intervals inside the engines: ``serve.submit``,
``serve.dispatch``, ``serve.backpressure``, ``serve.block`` and
``serve.slice`` on the host and ``serve.tile`` on the device for each
tile, and ``train.step`` on the host for each training step; of the
phases the program names, it records those the readers read
(``PHASES``: nerf's ``head``, the step's ``forward``, ``backward`` and
``adam``), each a host span and a device interval, and no other, so a
path of many phases (nsdf's 48 sphere-tracing steps a tile) keeps its
pace. ``TRACER.spans_ns()`` gives them in ``CLOCK_REALTIME``
nanoseconds, the clock of the device trace's events
(``trace.DeviceTrace``) and of the harness's own spans, each as
``(name, cat, start, end, args, device)``: ``device`` is None for a host
span and the CUDA device's index for a device interval.

The readers of these spans (``metrics/<name>.py``) call ``start()`` when
they are loaded: a traced run (``bench.run_cell`` with ``trace``) loads
its readers before it builds the program, so the tracer then runs from
set-up to the end of the window, and ``spans(run)`` keeps what began
inside the window. Loaded anywhere else (a test, a listing of the
metrics) ``start()`` does nothing. It finds the traced run by looking up
the stack for ``bench.run_cell``'s frame and its ``trace``; a cell kind
that enabled the tracer around its window itself would need no search.
A run whose namespace carries ``program_spans`` is read from that
instead. A program whose tracer has no ``spans_ns()`` is left alone, and
every reader of it returns None.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ngbench.trace import idle_gaps

# the tracer's buffers while the harness runs it, with room to spare over
# the few spans a tile or a step records
MAX_EVENTS = 500_000
# the phases the readers read, the only ones the tracer records
PHASES = ("head", "forward", "backward", "adam")

Span = Tuple[str, str, int, int, Dict, Optional[int]]

_cache: Dict[Tuple[int, int], Optional[List[Span]]] = {}


def _tracer():
    """The port's process tracer, through the module that imports the
    port; None when it has no ``spans_ns``."""
    from ngbench import program  # noqa: F401  (puts the port on the path)
    from repro_torch.obs import trace
    tracer = trace.TRACER
    return tracer if hasattr(tracer, "spans_ns") else None


def _in_a_traced_run() -> bool:
    """Whether the caller runs inside ``bench.run_cell`` with ``trace``."""
    from ngbench import bench
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code is bench.run_cell.__code__:
            return bool(frame.f_locals.get("trace"))
        frame = frame.f_back
    return False


def start() -> None:
    """Switch the program's tracer on, emptied, when a traced run loads
    the readers (module docstring); otherwise do nothing."""
    if not _in_a_traced_run():
        return
    tracer = _tracer()
    if tracer is None or tracer.enabled:
        return
    tracer.max_events = max(tracer.max_events, MAX_EVENTS)
    tracer.clear()
    tracer.enable(phases=PHASES)


def spans(run) -> Optional[List[Span]]:
    """The program's spans that began inside the traced window
    ``[run.trace.w0, run.trace.w1)``; None when the program recorded
    none, or dropped some for want of room."""
    w0, w1 = run.trace.w0, run.trace.w1
    given = getattr(run, "program_spans", None)
    if given is not None:
        return [tuple(sp) for sp in given if w0 <= sp[2] < w1]
    if (w0, w1) not in _cache:
        tracer = _tracer()
        if tracer is None or not tracer.enabled or tracer.dropped:
            _cache[(w0, w1)] = None
        else:
            _cache[(w0, w1)] = [tuple(sp) for sp in tracer.spans_ns()
                                if w0 <= sp[2] < w1]
    return _cache[(w0, w1)]


def device_ms_per_unit(run, name: str, units: int) -> Optional[float]:
    """Device milliseconds of the ``name`` intervals over ``units``; None
    when there are none."""
    sp = spans(run)
    if not sp or not units:
        return None
    total = sum(e - s for n, _, s, e, _, dev in sp
                if n == name and dev is not None)
    return total / 1e6 / units if total > 0 else None


def queue_wait_ms(sp: Sequence[Span]) -> Optional[float]:
    """The mean, over the tiles whose ``serve.tile`` interval and
    ``serve.dispatch`` span both began in the window, of the time from
    the end of the dispatch to the start of the tile on the device (0
    where the device began first), in ms."""
    dispatched = {args.get("req"): e for n, _, _, e, args, dev in sp
                  if n == "serve.dispatch" and dev is None}
    waits = [max(0, s - dispatched[args["req"]])
             for n, _, s, _, args, dev in sp
             if n == "serve.tile" and dev is not None
             and args.get("req") in dispatched]
    return sum(waits) / len(waits) / 1e6 if waits else None


def _merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_ns(a: Sequence[Tuple[int, int]],
               b: Sequence[Tuple[int, int]]) -> int:
    """Nanoseconds that the union of ``a`` and the union of ``b`` share."""
    a, b = _merged(a), _merged(b)
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_pct(run, names: Sequence[str]) -> Optional[float]:
    """The share of the window, in %, in which the device trace shows no
    event while the host is inside a span of one of ``names``; None when
    the program recorded none of them."""
    sp = spans(run)
    host = [(s, e) for n, _, s, e, _, dev in sp or ()
            if n in names and dev is None]
    tr = run.trace
    if not host or tr.w1 <= tr.w0:
        return None
    gaps = idle_gaps([(s, e) for _, s, e in tr.events], tr.w0, tr.w1)
    return 100.0 * overlap_ns(host, gaps) / (tr.w1 - tr.w0)
