"""Host spans and device intervals on one clock.

The JAX package's ``obs/trace.py`` for PyTorch, extended so that a traced
run explains each layer from inside. The process tracer ``TRACER`` keeps
two kinds of record, both in bounded buffers:

  * **host spans**: nested host intervals (thread-local stack: depth and
    parent), stamped with ``time.perf_counter``;
  * **device intervals**: a pair of ``torch.cuda.Event(enable_timing=True)``
    recorded on a CUDA stream at a span's entry and exit. Recording an
    event does not wait for the device, and the pair is resolved
    (``elapsed_time``) only when the trace is read, so no span ever waits
    on the device.

``spans_ns()`` gives both on ``CLOCK_REALTIME`` (``time.time_ns()``), the
clock of ``torch.profiler``'s device events: the host stamps through one
pairing of ``perf_counter`` with ``time_ns``, taken when the tracer is
made and at each ``clear()``; each device's intervals through anchors,
timing events recorded on an idle stream of that device and paired with
``time_ns``, the first before the device's first interval and a fresh one
each second after (``_ANCHOR_EVERY_NS``). ``events()`` and
``export()`` give the Chrome-trace records (``obs/export.py``, viewable in
``chrome://tracing``/Perfetto), device intervals on a row of their own.

``TRACER`` is **disabled by default**: a disabled ``span()`` returns a
shared null object, and the serve and train engines add their events and
scopes only while it is enabled.

``annotate(name)`` names a phase (taxonomy in ``obs/__init__.py``). While
``TRACER`` is enabled (and ``enable(phases=...)`` does not leave the
phase out) it is a span of category ``phase``, with a device interval
when the enclosing ``scope()`` names a CUDA device; while a profiler is
active it is also a ``torch.profiler.record_function`` range.
With neither it returns one shared null context and enters nothing:
``record_function`` would still enter a dispatcher op on every call, and
the serve path calls the field wrappers tens of times a request.

``scope(device, **args)`` is what an engine opens around one request or
step: every span opened inside it carries ``args`` (``req`` or
``step``), and its phases' device intervals go to ``device``.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL_CONTEXT = contextlib.nullcontext()
# the process id each event carries, read once (and again in a forked
# child): os.getpid() is a system call on every event otherwise
_PID = [os.getpid()]
os.register_at_fork(after_in_child=lambda: _PID.__setitem__(0, os.getpid()))
# a device anchor is taken again, up to _ANCHOR_TRIES times, until the
# host's clock reads around its record and its completion lie this close
# (ns)
_ANCHOR_TIGHT_NS = 20_000
_ANCHOR_TRIES = 5
# a device is anchored again when its last anchor is this old (ns)
_ANCHOR_EVERY_NS = 1_000_000_000


def _index(device) -> int:
    """A CUDA device's index (the current device's for a bare "cuda")."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    index = device.index
    return torch.cuda.current_device() if index is None else index


def annotate(name: str):
    """A phase: while ``TRACER`` is enabled and records it, a span of
    category ``phase`` and, in a scope on a CUDA device, its device
    interval, inside a ``record_function`` range while a profiler is
    active; else, while a profiler is active, the ``record_function(name)``
    range alone; otherwise the shared null context, which costs two
    attribute reads."""
    if TRACER.enabled and (TRACER.phases is None or name in TRACER.phases):
        return TRACER.phase(name)
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_CONTEXT
    return torch.profiler.record_function(name)


def _cuda_tensors(value) -> Iterator[torch.Tensor]:
    """The CUDA tensors in ``value``: a tensor, or lists, tuples and dicts
    of them."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _cuda_tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _cuda_tensors(v)


# repro: sync-boundary timing primitive — syncing IS its semantics
def time_fn(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall time (s) of ``fn(*args)``: ``warmup`` calls excluded,
    then the median of ``iters`` calls, each ended by
    ``torch.cuda.synchronize`` of the devices its result's CUDA tensors
    lie on (a CPU result is done when ``fn`` returns)."""
    def call():
        out = fn(*args)
        for dev in {t.device for t in _cuda_tensors(out)}:
            torch.cuda.synchronize(dev)
    for _ in range(warmup):
        call()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


class SpanNs(NamedTuple):
    """One record of ``Tracer.spans_ns()``: ``start`` and ``end`` in
    ``CLOCK_REALTIME`` nanoseconds; ``device`` is None for a host span and
    the CUDA device's index for a device interval."""
    name: str
    cat: str
    start: int
    end: int
    args: Dict
    device: Optional[int]


class _NullSpan:
    """Shared no-op span: what a disabled tracer hands out."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One host span; with ``device``, also its device interval on that
    device's current stream; with ``ranged``, inside a profiler range."""
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_depth",
                 "_parent", "_device", "_ev0", "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict,
                 device: Optional[torch.device] = None,
                 ranged: bool = False):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._device = device
        self._ev0 = None
        self._range = (torch.profiler.record_function(name) if ranged
                       else None)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        stack = self._tracer._stack()
        self._depth = len(stack)
        self._parent = stack[-1] if stack else ""
        stack.append(self.name)
        if self._device is not None:
            self._ev0 = self._tracer.device_event(self._device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._device is not None:
            ev1 = (None if self._ev0 is None
                   else self._tracer.device_event(self._device))
            self._tracer.add_interval(self.name, self._device, self._ev0,
                                      ev1, cat=self.cat, **self.args)
        self._tracer._stack().pop()
        self._tracer.add_event(self.name, self._t0, t1, cat=self.cat,
                               depth=self._depth, parent=self._parent,
                               **self.args)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class _Scope:
    """The args and device of the spans opened inside it, on this thread;
    leaving it restores the scope it was opened in."""
    __slots__ = ("_tracer", "_scope", "_prev")

    def __init__(self, tracer: "Tracer", device, args: Dict):
        self._tracer = tracer
        self._scope = (device, args)

    def __enter__(self):
        local = self._tracer._local
        self._prev = getattr(local, "scope", None)
        local.scope = self._scope
        return self

    def __exit__(self, *exc):
        self._tracer._local.scope = self._prev
        return False


class Tracer:
    """Bounded buffers of host spans and device intervals, and the span
    factory (module docstring). ``max_events`` bounds each buffer; what
    does not fit is counted in ``dropped`` and creates no CUDA event."""

    def __init__(self, max_events: int = 200_000):
        self.enabled = False
        self.phases: Optional[frozenset] = None
        self.max_events = max_events
        self.dropped = 0
        self._events: List[tuple] = []
        self._intervals: List[tuple] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._idle_streams: Dict[int, "torch.cuda.Stream"] = {}
        self._mark_epoch()

    def _mark_epoch(self):
        """Pair ``perf_counter`` with ``time_ns`` (the host stamps' way to
        ``CLOCK_REALTIME``) and forget the device anchors."""
        a = time.perf_counter()
        ns = time.time_ns()
        self._epoch = (a + time.perf_counter()) / 2
        self._epoch_ns = ns
        self._anchors: Dict[int, List[tuple]] = {}

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # ------------------------------------------------------------ control
    def enable(self, phases=None):
        """Record from now on; ``phases`` (names) limits the phases that
        ``annotate`` records, each a host span and a device interval
        (None: every phase). A recorded phase costs tens of microseconds
        of host time, so a reader that needs a few phases names them, and
        a host-paced path of many phases keeps its pace."""
        self.phases = None if phases is None else frozenset(phases)
        self.enabled = True

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._events = []
            self._intervals = []
            self.dropped = 0
            self._mark_epoch()

    # ------------------------------------------------------------- record
    def span(self, name: str, cat: str = "host", **args):
        """Context manager for one nested host span, carrying the args of
        the enclosing ``scope()``. Disabled tracer -> the shared null
        span (no allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        scope = getattr(self._local, "scope", None)
        if scope is not None:
            args = {**scope[1], **args}
        return _Span(self, name, cat, args)

    def phase(self, name: str) -> _Span:
        """``annotate``'s span while enabled: category ``phase``, the
        enclosing scope's args, a device interval on the scope's device
        when that is a CUDA device, inside a profiler range while a
        profiler is active."""
        device, args = getattr(self._local, "scope", None) or (None, {})
        if device is not None and device.type != "cuda":
            device = None
        return _Span(self, name, "phase", args, device,
                     ranged=_autograd_profiler._is_profiler_enabled)

    def scope(self, device=None, **args):
        """The args (and the device of the phases' intervals) of every
        span opened inside it on this thread. Disabled -> the shared null
        context."""
        if not self.enabled:
            return _NULL_CONTEXT
        return _Scope(self, None if device is None else torch.device(device),
                      args)

    def add_event(self, name: str, t0: float, t1: float,
                  cat: str = "host", **args):
        """Record a complete host span from explicit ``perf_counter``
        stamps (the hot-path API: callers time with their own counters and
        only call this when ``enabled``). It keeps the raw stamps in a
        tuple; ``events()`` and ``spans_ns()`` convert them."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append((name, cat, t0, t1, _PID[0],
                                 threading.get_ident(), args))

    def device_event(self, device) -> Optional["torch.cuda.Event"]:
        """A timing event recorded now on the current stream of CUDA
        ``device`` (the device anchored first), or None once the interval
        buffer is full (nothing is then created)."""
        if len(self._intervals) >= self.max_events:
            return None
        index = _index(device)
        self._anchor(index)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(index))
        return ev

    def add_interval(self, name: str, device, ev0, ev1, cat: str = "device",
                     **args):
        """Record a device interval between two timing events recorded on
        ``device``'s stream, ``ev0`` from ``device_event`` (the hot-path
        API: nothing waits for them here). A missing event (a full buffer)
        counts as dropped."""
        if not self.enabled:
            return
        with self._lock:
            if ev0 is None or ev1 is None \
                    or len(self._intervals) >= self.max_events:
                self.dropped += 1
                return
            self._intervals.append((name, cat, ev0, ev1, _index(device),
                                    args))

    def _anchor(self, index: int) -> None:
        """Make sure device ``index`` has an anchor younger than
        ``_ANCHOR_EVERY_NS``: a timing event recorded on an idle stream of
        the device and paired with ``time_ns``. The host reads the clock,
        records the event and polls it until the device has passed it (an
        idle stream's event: microseconds, whatever the device's other
        streams hold), then reads the clock again; of up to
        ``_ANCHOR_TRIES`` tries the tightest pair is kept, its midpoint
        the anchor's time. Fresh anchors keep the device clock's drift
        from ``CLOCK_REALTIME`` and the float32 of ``elapsed_time`` out of
        long traces."""
        anchors = self._anchors.get(index)
        if anchors and time.time_ns() - anchors[-1][1] < _ANCHOR_EVERY_NS:
            return
        stream = self._idle_streams.get(index)
        if stream is None:
            stream = self._idle_streams[index] = torch.cuda.Stream(index)
        best = None
        for _ in range(_ANCHOR_TRIES):
            ev = torch.cuda.Event(enable_timing=True)
            a = time.time_ns()
            ev.record(stream)
            while not ev.query():
                pass
            b = time.time_ns()
            if best is None or b - a < best[2]:
                best = (ev, (a + b) // 2, b - a)
            if b - a < _ANCHOR_TIGHT_NS:
                break
        with self._lock:
            self._anchors.setdefault(index, []).append(best)

    # ------------------------------------------------------------- export
    def _host_ns(self, t: float, epoch: float, epoch_ns: int) -> int:
        return epoch_ns + round((t - epoch) * 1e9)

    # repro: sync-boundary reading the trace resolves its device intervals
    def _resolved(self, intervals, anchors) -> List[SpanNs]:
        """The device intervals in ``CLOCK_REALTIME`` ns, each event from
        the last anchor of its device recorded before it. Waits for the
        devices: the trace is being read."""
        for index in {iv[4] for iv in intervals}:
            torch.cuda.synchronize(index)
        # each device's anchors on its first anchor's clock (ms)
        at = {i: [a[0][0].elapsed_time(ev) for ev, _, _ in a]
              for i, a in anchors.items()}

        def ns(index, ev) -> int:
            a = anchors[index]
            j = max(0, bisect.bisect_right(
                at[index], a[0][0].elapsed_time(ev)) - 1)
            return a[j][1] + round(a[j][0].elapsed_time(ev) * 1e6)
        return [SpanNs(name, cat, ns(index, ev0), ns(index, ev1), args,
                       index)
                for name, cat, ev0, ev1, index, args in intervals]

    def spans_ns(self) -> List[SpanNs]:
        """Every host span and device interval recorded since the last
        ``clear()``, in ``CLOCK_REALTIME`` nanoseconds: host spans first,
        in the order they closed, then device intervals."""
        with self._lock:
            raw, intervals = list(self._events), list(self._intervals)
            epoch, epoch_ns = self._epoch, self._epoch_ns
            anchors = {i: list(a) for i, a in self._anchors.items()}
        out = [SpanNs(name, cat, self._host_ns(t0, epoch, epoch_ns),
                      self._host_ns(t1, epoch, epoch_ns), args, None)
               for name, cat, t0, t1, _, _, args in raw]
        return out + self._resolved(intervals, anchors)

    def events(self) -> List[Dict]:
        """The recorded spans as Chrome-trace "X" records, ``ts`` from the
        epoch of the last ``clear()``; device intervals with ``tid`` the
        device's index and ``cat`` prefixed ``device:``."""
        with self._lock:
            raw, intervals = list(self._events), list(self._intervals)
            epoch, epoch_ns = self._epoch, self._epoch_ns
            anchors = {i: list(a) for i, a in self._anchors.items()}
        out = [{"name": name, "cat": cat, "ph": "X",
                "ts": (t0 - epoch) * 1e6,
                "dur": max(0.0, (t1 - t0) * 1e6),
                "pid": pid, "tid": tid % (1 << 31), "args": args}
               for name, cat, t0, t1, pid, tid, args in raw]
        for sp in self._resolved(intervals, anchors) if intervals else ():
            out.append({"name": sp.name, "cat": f"device:{sp.cat}",
                        "ph": "X", "ts": (sp.start - epoch_ns) / 1e3,
                        "dur": max(0.0, (sp.end - sp.start) / 1e3),
                        "pid": _PID[0], "tid": sp.device, "args": sp.args})
        return out

    def export(self, path) -> Dict:
        """Write Chrome-trace JSON; returns the trace object."""
        from repro_torch.obs import export as export_mod
        return export_mod.write_chrome_trace(path, self.events(),
                                             dropped=self.dropped)

    def phase_totals(self, cat: Optional[str] = None) -> Dict[str, float]:
        """Total seconds per span name (optionally one category)."""
        out: Dict[str, float] = {}
        for ev in self.events():
            if cat is not None and ev["cat"] != cat:
                continue
            out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"] / 1e6
        return out


TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER
