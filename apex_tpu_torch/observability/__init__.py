"""apex_tpu_torch.observability: the host-side telemetry the serving
engines use.

Counterpart of the stdlib layers of ``apex_tpu/observability``:

1. **Metrics** (:mod:`.metrics`): a :class:`MetricsRegistry` of
   counters, gauges and fixed-bucket histograms.
2. **Spans/events** (:mod:`.tracing`): :class:`SpanRecorder` wall-clock
   ranges over ``utils.profiler``'s ranges, request-scoped trace context,
   Chrome-trace and JSONL exports.

The rest of the JAX package's plane (device metrics, the compilation,
memory, cost-model, numerics and timeline modules, the flight recorder,
exporters and the server) is ROADMAP.md queue 1, item 9.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, set_registry)
from .tracing import (SpanRecorder, event, get_recorder, maybe_event,
                      maybe_span, new_trace_id, set_recorder, span)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "SpanRecorder", "span", "event",
           "maybe_span", "maybe_event", "get_recorder", "set_recorder",
           "new_trace_id"]
