"""repro_torch.obs -- the zero-perturbation telemetry plane.

Span tracing (Chrome-trace/Perfetto JSON), a metrics registry (counters /
gauges / HDR histograms -> JSONL), and the process-wide session that owns
both.  Import-time constraint: this package is **stdlib-only**; torch is
only ever looked up lazily at call time (``trace._host_time_ok``).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, load_jsonl)
from repro_torch.obs.runtime import (ObsConfig, ObsSession, active,
                                     metrics_for, metrics_registry, session,
                                     span, tracer, tracer_for)
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "load_jsonl",
    "ObsConfig", "ObsSession", "active", "metrics_for", "metrics_registry",
    "session", "span", "tracer", "tracer_for",
    "NULL_SPAN", "Span", "Tracer",
]
