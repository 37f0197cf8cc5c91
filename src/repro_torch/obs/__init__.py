"""``repro_torch.obs`` — tracing and metrics (copied from the JAX package).

* :mod:`~repro_torch.obs.trace` — :class:`Tracer` (explicit spans,
  Chrome trace / Perfetto JSON export) and the zero-alloc
  :data:`NULL_TRACER` default;
* :mod:`~repro_torch.obs.metrics` — :class:`MetricsRegistry` (counters,
  gauges, windowed histograms) and the versioned JSON snapshot codec.
"""

from .trace import (HOST_TRACK, NULL_TRACER, NullTracer, SPAN_NAMES, Span,
                    Tracer, activate, current, from_chrome_trace, scoped,
                    span_tree, validate_chrome_trace)
from .metrics import (Counter, DEFAULT_WINDOW, Gauge, Histogram,
                      METRICS_SCHEMA_VERSION, MetricsRegistry, NULL_REGISTRY,
                      NullRegistry, default_registry, flatten, open_snapshot,
                      percentiles, quantile, registry_from_values)

__all__ = [
    "HOST_TRACK", "NULL_TRACER", "NullTracer", "SPAN_NAMES", "Span",
    "Tracer", "activate", "current", "from_chrome_trace", "scoped",
    "span_tree", "validate_chrome_trace",
    "Counter", "DEFAULT_WINDOW", "Gauge", "Histogram",
    "METRICS_SCHEMA_VERSION", "MetricsRegistry", "NULL_REGISTRY",
    "NullRegistry", "default_registry", "flatten", "open_snapshot",
    "percentiles", "quantile", "registry_from_values",
]
