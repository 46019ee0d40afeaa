"""Fleet-health machinery: heartbeats, straggler detection, failure policy.

A copy of the JAX package's ``runtime/health.py`` (which is
framework-free), so that the port imports nothing of that package; a
``FailureEvent`` hands off to the re-mesh of ``runtime/elastic.py``.

On a real fleet these hooks attach to the cluster scheduler; here they are
unit-tested against simulated clocks and step times, beside the JAX
package's, and the training engine (``train/loop.py``) beats, records and
polls them once per chunk.

Per-host step-time stats live in windowed ``obs.metrics.Histogram``s
(DESIGN.md §8) — when a ``Registry`` is supplied (the training engine
passes its own), the detector's histograms ARE the registry's
``health.step_s.<host>`` entries, so straggler detection and the metrics
snapshot read the same data instead of a private deque. ``FailurePolicy``
additionally surfaces *silent* hosts — hosts that heartbeat but never
record a step time, previously invisible to straggler detection — as the
``health.silent_hosts`` gauge.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks last-seen times per host; flags dead hosts."""
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic
    _last: Dict[str, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: str):
        self._last[host] = self.clock()

    def hosts(self) -> List[str]:
        return sorted(self._last)

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)

    def alive_hosts(self) -> List[str]:
        dead = set(self.dead_hosts())
        return sorted(h for h in self._last if h not in dead)


@dataclasses.dataclass
class StragglerDetector:
    """Rolling per-host step-time stats; flags hosts slower than
    ``threshold`` x the fleet median (the standard mitigation at scale is
    to hot-swap the host or drop it at the next elastic boundary).

    Backed by ``obs.metrics.Histogram(window=window)`` per host — the
    median is the histogram p50 (within one ~10% bucket of the exact
    rolling median; straggler thresholds are 1.5x+, far coarser). With
    ``registry`` set the histograms are registry-owned
    (``<prefix>.<host>``) and appear in its snapshot.
    """
    window: int = 32
    threshold: float = 1.5
    registry: Optional[obs_metrics.Registry] = None
    prefix: str = "health.step_s"
    _hists: Dict[str, obs_metrics.Histogram] = dataclasses.field(
        default_factory=dict)

    def _hist(self, host: str) -> obs_metrics.Histogram:
        h = self._hists.get(host)
        if h is None:
            if self.registry is not None:
                h = self.registry.histogram(f"{self.prefix}.{host}",
                                            window=self.window)
            else:
                h = obs_metrics.Histogram(host, window=self.window)
            self._hists[host] = h
        return h

    def record(self, host: str, step_time_s: float):
        self._hist(host).record(step_time_s)

    def hosts(self) -> List[str]:
        """Hosts with at least one recorded step time."""
        return sorted(h for h, hist in self._hists.items() if hist.count)

    def _median(self, xs: Sequence[float]) -> float:
        s = sorted(xs)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def host_medians(self) -> Dict[str, float]:
        return {h: hist.percentile(50)
                for h, hist in self._hists.items() if hist.count}

    def stragglers(self) -> List[str]:
        med = self.host_medians()
        if len(med) < 2:
            return []
        fleet = self._median(list(med.values()))
        return sorted(h for h, m in med.items()
                      if m > self.threshold * fleet)


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    kind: str          # 'dead' | 'straggler'
    hosts: tuple
    step: int


class FailurePolicy:
    """Decides when to trigger an elastic re-mesh.

    dead host      -> immediate remesh from last checkpoint
    stragglers     -> remesh at the next checkpoint boundary if persistent

    ``poll`` also refreshes the ``health.silent_hosts`` gauge (count of
    hosts the monitor has heartbeats for but the detector has never seen
    a step time from): such a host is healthy by heartbeat and invisible
    to the straggler median — the gauge is the only place it shows up.
    """

    def __init__(self, monitor: HeartbeatMonitor,
                 detector: StragglerDetector,
                 persistence_steps: int = 100,
                 registry: Optional[obs_metrics.Registry] = None):
        self.monitor = monitor
        self.detector = detector
        self.persistence = persistence_steps
        self.registry = (registry if registry is not None
                         else detector.registry) or obs_metrics.REGISTRY
        self._straggler_since: Dict[str, int] = {}

    def silent_hosts(self) -> List[str]:
        """Hosts that heartbeat but never recorded a step time."""
        return sorted(set(self.monitor.hosts())
                      - set(self.detector.hosts()))

    def poll(self, step: int) -> Optional[FailureEvent]:
        self.registry.gauge("health.silent_hosts").set(
            len(self.silent_hosts()))
        dead = self.monitor.dead_hosts()
        if dead:
            return FailureEvent("dead", tuple(dead), step)
        current = set(self.detector.stragglers())
        for h in list(self._straggler_since):
            if h not in current:
                del self._straggler_since[h]
        for h in current:
            self._straggler_since.setdefault(h, step)
        persistent = tuple(
            h for h, s0 in self._straggler_since.items()
            if step - s0 >= self.persistence)
        if persistent:
            return FailureEvent("straggler", persistent, step)
        return None
