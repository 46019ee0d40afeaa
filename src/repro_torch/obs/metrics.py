"""Metrics registry: named counters, gauges, streaming log-histograms.

A copy of the JAX package's ``obs/metrics.py`` (which is framework-free),
so that the port imports nothing of that package.

Histograms are fixed-bucket log histograms: percentiles come from bucket
counts (geometric midpoint of the containing bucket), never from an
unbounded sample list, so a serving process can record forever in O(1)
memory. The estimate of any percentile is off from the exact order
statistic by at most one bucket width (``bucket_growth``, ~10% relative
with the default 24 buckets/decade).

``REGISTRY`` is the process-global default (ad-hoc counters, health
gauges); subsystems that must not share state across instances (one
RenderEngine per test, one TrainEngine per run) embed their own
``Registry()``.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional

import numpy as np


class Counter:
    """Monotone named counter."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins named value."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float):
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket log histogram over ``[lo, hi)``.

    ``buckets_per_decade`` sets the resolution: bucket edges are
    ``lo * bucket_growth**i`` with ``bucket_growth = 10**(1/bpd)``.
    Values below ``lo`` land in the underflow bucket (reported as
    ``lo``), values at/above ``hi`` in the overflow bucket (reported as
    ``hi``).

    ``window``: when set, counts rotate through two generations every
    ``window`` records, so percentiles reflect the last ``window`` to
    ``2*window`` samples while ``count``/``sum``/``min``/``max`` stay
    lifetime totals. ``window=None`` (default) accumulates forever.
    """

    def __init__(self, name: str = "", lo: float = 1e-7, hi: float = 1e4,
                 buckets_per_decade: int = 24,
                 window: Optional[int] = None):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self.name = name
        self.lo = lo
        self.hi = hi
        self.bpd = buckets_per_decade
        self.window = window
        self._n_buckets = int(math.ceil(
            math.log10(hi / lo) * buckets_per_decade))
        # [0]=underflow, [1..n]=log buckets, [n+1]=overflow
        self._cur = np.zeros(self._n_buckets + 2, np.int64)
        self._prev = np.zeros(self._n_buckets + 2, np.int64)
        self._cur_n = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    @property
    def bucket_growth(self) -> float:
        """Multiplicative width of one bucket (the accuracy bound)."""
        return 10.0 ** (1.0 / self.bpd)

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self._n_buckets + 1
        return 1 + min(self._n_buckets - 1,
                       int(math.log10(v / self.lo) * self.bpd))

    def _edges(self, idx: int):
        """(lo, hi) value edges of bucket ``idx`` (1-based log buckets)."""
        g = self.bucket_growth
        return self.lo * g ** (idx - 1), self.lo * g ** idx

    def record(self, v: float):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self._cur[self._index(v)] += 1
            self._cur_n += 1
            if self.window is not None and self._cur_n >= self.window:
                self._prev, self._cur = self._cur, self._prev
                self._cur[:] = 0
                self._cur_n = 0

    def _merged(self) -> np.ndarray:
        return self._cur + self._prev if self.window is not None \
            else self._cur

    def percentile(self, p: float) -> float:
        """Estimate of the exact percentile's order statistic, using the
        same rank formula as a sorted-list lookup
        (``k = round(p/100 * (n-1))``) so both land in the same bucket —
        the estimate is the bucket's geometric midpoint, within one
        ``bucket_growth`` of the exact value."""
        with self._lock:
            counts = self._merged().copy()
        n = int(counts.sum())
        if n == 0:
            return float("nan")
        k = min(n - 1, int(round(p / 100.0 * (n - 1))))
        cum = np.cumsum(counts)
        idx = int(np.searchsorted(cum, k + 1))
        if idx == 0:
            return self.lo
        if idx == self._n_buckets + 1:
            return self.hi
        e0, e1 = self._edges(idx)
        return math.sqrt(e0 * e1)

    def snapshot(self) -> Dict[str, float]:
        empty = self.count == 0
        return {
            "count": float(self.count),
            "sum": self.sum,
            "min": 0.0 if empty else self.min,
            "max": 0.0 if empty else self.max,
            "p50": 0.0 if empty else self.percentile(50),
            "p90": 0.0 if empty else self.percentile(90),
            "p99": 0.0 if empty else self.percentile(99),
        }


class Registry:
    """Named get-or-create store of counters/gauges/histograms."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, **kwargs) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, **kwargs)
            return h

    def names(self) -> List[str]:
        return sorted(list(self._counters) + list(self._gauges)
                      + list(self._histograms))

    def snapshot(self) -> Dict:
        """The metrics-snapshot JSON object (the shape of the JAX package's
        ``benchmarks/schemas/metrics_snapshot.schema.json``)."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "histograms": {n: h.snapshot()
                           for n, h in self._histograms.items()},
        }

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **kwargs)

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY
