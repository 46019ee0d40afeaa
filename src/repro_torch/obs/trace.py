"""Host-side span tracer with explicit device-sync boundaries.

The JAX package's ``obs/trace.py`` for PyTorch. Spans are nested host
intervals (thread-local stack) exported as Chrome-trace "X" events
(``obs/export.py``, viewable in ``chrome://tracing``/Perfetto). Two sync
disciplines:

  * **async (default)**: a span measures host time only: submit-side spans
    on the serve path never wait for the device, so tracing cannot perturb
    PyTorch's asynchronous launches. A span's end time is whenever the
    host leaves the ``with`` block.
  * **synced** (``TRACER.enable(sync=True)``): a span that ``bind()``-ed a
    tensor waits at close for the device work queued before it on the
    tensor's stream (a CUDA event recorded there, then synchronized), so
    the span covers device completion.

The process tracer ``TRACER`` is **disabled by default**; a disabled
``span()`` returns a shared null object (no allocation, no sync). The
serve engine and the training engine add their events through
``add_event`` only while it is enabled.

``annotate(name)`` is the in-trace counterpart: a
``torch.profiler.record_function`` range, so ``torch.profiler`` traces
carry the phase names the host spans use (taxonomy: encode | mlp |
encode_mlp | raymarch | compact | composite | host). With no profiler
active it returns one shared null context and enters nothing:
``record_function`` would still enter a dispatcher op on every call, and
the serve path calls the field wrappers tens of times a request.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL_CONTEXT = contextlib.nullcontext()
# the process id each event carries, read once (and again in a forked
# child): os.getpid() is a system call on every event otherwise
_PID = [os.getpid()]
os.register_at_fork(after_in_child=lambda: _PID.__setitem__(0, os.getpid()))


def annotate(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    is active; otherwise the shared null context, which costs one
    attribute read."""
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


# repro: sync-boundary a synced span's wait on its bound value's streams
def _wait_for(value) -> None:
    """Wait for the device work queued so far on the current stream of
    each CUDA device ``value``'s tensors lie on: a CUDA event recorded
    there, then synchronized. CPU tensors need no wait."""
    for dev in {t.device for t in _cuda_tensors(value)}:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()


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


class _NullSpan:
    """Shared no-op span: what a disabled tracer hands out."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def bind(self, value):
        return value


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_bound",
                 "_depth", "_parent")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._bound = None

    def bind(self, value):
        """Attach a tensor (or a list, tuple or dict of them); in synced
        mode the span waits at close for the device work queued before it
        on their streams. Returns ``value``."""
        self._bound = value
        return value

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        self._parent = stack[-1] if stack else ""
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    # repro: sync-boundary a synced span's close waits on its bound value
    def __exit__(self, *exc):
        if self._tracer.sync and self._bound is not None:
            _wait_for(self._bound)
        t1 = time.perf_counter()
        self._tracer._stack().pop()
        self._tracer.add_event(self.name, self._t0, t1, cat=self.cat,
                               depth=self._depth, parent=self._parent,
                               **self.args)
        return False


class Tracer:
    """Bounded event buffer + span factory (module docstring)."""

    def __init__(self, max_events: int = 200_000):
        self.enabled = False
        self.sync = False
        self.max_events = max_events
        self.dropped = 0
        self._events: List[tuple] = []
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # ------------------------------------------------------------ control
    def enable(self, sync: bool = False):
        self.enabled = True
        self.sync = sync

    def disable(self):
        self.enabled = False
        self.sync = False

    def clear(self):
        with self._lock:
            self._events = []
            self.dropped = 0
            self._epoch = time.perf_counter()

    # ------------------------------------------------------------- record
    def span(self, name: str, cat: str = "host", **args):
        """Context manager for one nested span. Disabled tracer -> the
        shared null span (no allocation, never syncs)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def add_event(self, name: str, t0: float, t1: float,
                  cat: str = "host", **args):
        """Record a complete event from explicit ``perf_counter`` stamps
        (the hot-path API: callers time with their own counters and only
        call this when ``enabled``). It keeps the raw stamps in a tuple;
        ``events()`` builds the Chrome-trace records."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append((name, cat, t0, t1, _PID[0],
                                 threading.get_ident(), args))

    # ------------------------------------------------------------- export
    def events(self) -> List[Dict]:
        """The recorded events as Chrome-trace "X" records, ``ts`` from
        the epoch of the last ``clear()``."""
        with self._lock:
            raw, epoch = list(self._events), self._epoch
        return [{"name": name, "cat": cat, "ph": "X",
                 "ts": (t0 - epoch) * 1e6,
                 "dur": max(0.0, (t1 - t0) * 1e6),
                 "pid": pid, "tid": tid % (1 << 31), "args": args}
                for name, cat, t0, t1, pid, tid, args in raw]

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
