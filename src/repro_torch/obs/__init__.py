"""Observability for the port, as in the JAX package's ``obs``:

  * ``obs.trace``   — nested host spans and device intervals (CUDA timing
    events, resolved only when the trace is read), both on
    ``CLOCK_REALTIME`` through ``spans_ns()``; ``annotate()`` names a
    phase (a span while the tracer is enabled,
    ``torch.profiler.record_function`` while a profiler is active); the
    process tracer is disabled by default and a disabled span is a shared
    null object.
  * ``obs.metrics`` — process-global and embeddable registries of named
    counters, gauges and fixed-bucket log histograms, snapshot → JSON.
  * ``obs.export``  — Chrome-trace JSON and the schema-subset validator
    for the checked-in metrics-snapshot schema.
  * ``obs.log``     — leveled JSON-lines structured logging.

Phase taxonomy (spans, profiler ranges and metric names):
``encode | mlp | encode_mlp | raymarch | compact | composite | host`` and
``head`` (nerf's and nvr's activations after the field call, with nerf's
colour input and colour MLP), ``forward``, ``backward`` and ``adam`` (a
training step's loss, its gradients and the optimizer).
"""
from repro_torch.obs.log import Logger, get_logger, set_level
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     REGISTRY, get_registry)
from repro_torch.obs.trace import (TRACER, Tracer, annotate, get_tracer,
                                   time_fn)
from repro_torch.obs import export

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "get_registry", "Logger", "get_logger", "set_level",
    "TRACER", "Tracer", "annotate", "get_tracer", "time_fn", "export",
]
