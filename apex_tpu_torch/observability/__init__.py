"""apex_tpu_torch.observability: the host-side telemetry of the serving
engines and the fleet.

Counterpart of the stdlib layers of ``apex_tpu/observability``:

1. **Metrics** (:mod:`.metrics`): a :class:`MetricsRegistry` of
   counters, gauges and fixed-bucket histograms.
2. **Spans/events** (:mod:`.tracing`): :class:`SpanRecorder` wall-clock
   ranges over ``utils.profiler``'s ranges, request-scoped trace context,
   Chrome-trace and JSONL exports.
3. **Exporters** (:mod:`.exporters`): schema-versioned JSONL
   (:class:`JsonlExporter`), Prometheus text exposition, and every
   record validator (``validate_fleet_record``, ``validate_trace_record``,
   ``validate_recovery_record``, ``validate_telemetry_record``, ...).

Plus the **flight recorder** (:mod:`.flightrec`): :class:`EventRing`, a
bounded ring of operational transitions (breaker, failover, drain,
stall, shed, injected faults, quarantined samples) dumpable on fault.

The rest of the JAX package's plane (device metrics, the compilation,
memory, cost-model, numerics, step-time and timeline modules, the
supervisor and the introspection server) is ROADMAP.md queue 1, item 9.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, set_registry)
from .tracing import (SpanRecorder, event, get_recorder, maybe_event,
                      maybe_span, new_trace_id, set_recorder, span)
from .flightrec import EventRing, get_ring, set_ring
from .exporters import (SCHEMA_VERSION, JsonlExporter, host_info,
                        prometheus_text, validate_bench_jsonl,
                        validate_bench_record)
from . import exporters, flightrec, metrics, tracing

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "SpanRecorder", "span", "event",
           "maybe_span", "maybe_event", "get_recorder", "set_recorder",
           "new_trace_id", "EventRing", "get_ring", "set_ring",
           "SCHEMA_VERSION", "JsonlExporter", "prometheus_text",
           "host_info", "validate_bench_record", "validate_bench_jsonl",
           "metrics", "tracing", "flightrec", "exporters"]
