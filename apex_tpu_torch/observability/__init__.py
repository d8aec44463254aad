"""apex_tpu_torch.observability: the telemetry of the serving engines,
the fleet and the training run.

Counterpart of ``apex_tpu/observability``, module for module:

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

The training-run plane:

4. **Device metrics** (:class:`DeviceMetrics`): counters, gauges and
   histograms held in device tensors a training step updates in place
   (so they ride a ``make_step`` CUDA graph), read back by one copy.
5. **Numerics** (:mod:`.numerics`): :class:`NumericsMonitor`'s
   per-layer gradient health and overflow attribution, the DDP
   buckets' stats and the cross-replica divergence digest.
6. **Step-time attribution** (:mod:`.steptime`): the compute / comm
   split of a step by blocked-fetch differential timing, and with
   ``capture_timeline=True`` the measured device-timeline split.
7. **The run supervisor** (:mod:`.supervisor`): :class:`RunSupervisor`
   turns the host values a run already fetched into stall, loss-spike,
   NaN, throughput, divergence and recompilation-storm verdicts, which
   ``fleet.ElasticTrainer`` acts on.

And the compile, memory, cost and device-time planes:

8. **The compilation ledger** (:mod:`.compilation`):
   :class:`CompilationLedger` records every CUDA-graph capture of an
   instrumented entry (``make_step``, the engines' admission and decode
   graphs; on the CPU each entry's first call) and every kernel build
   (``nvcc:<source>``, cache hit or miss), with the retrace differ
   naming the culprit argument of a signature change — the
   ``xla_retrace`` ring events the supervisor's storm detector reads,
   the zero-retrace contracts, ``/compilez``.
9. **Memory** (:mod:`.memory`): a captured graph's memory plan from the
   allocator's counts around its capture, the last-use liveness scan
   over a ``make_fx`` graph, and the live-tensor gauges.
10. **The cost model** (:mod:`.costmodel`): ``count_cost`` prices one
    call's aten operators by the JAX package's rules (valid-position
    convolutions, exact matmul flops by dtype), the port's kernels as
    their plain versions (the flash kernels at the JAX dense path's
    count); ``peak_flops`` / ``mfu`` with the H100's
    row.
11. **Device-time truth** (:mod:`.timeline`): the ``torch.profiler``
    trace parsed into per-step device busy time, per-kernel top-k,
    compute vs collective vs gap and a measured overlap fraction;
    ``kind: profile`` records and the server's on-demand ``/profilez``.
12. **The introspection server** (:mod:`.server`): ``/healthz``,
    ``/metricsz``, ``/statusz``, ``/flightz``, ``/tracez``,
    ``/profilez``, ``/compilez``, ``/tenantz`` over a live registry,
    ring, recorder and ledger, attached to an engine, a fleet or a
    supervisor by one ``server.serve(...)`` call.
"""

from .metrics import (DEFAULT_LATENCY_BUCKETS, Counter, DeviceMetrics,
                      Gauge, Histogram, MetricsRegistry, get_registry,
                      set_registry)
from .tracing import (SpanRecorder, event, get_recorder, maybe_event,
                      maybe_span, new_trace_id, set_recorder, span)
from .flightrec import EventRing, get_ring, set_ring
from .exporters import (SCHEMA_VERSION, JsonlExporter, host_info,
                        prometheus_text, validate_bench_jsonl,
                        validate_bench_record)
from .costmodel import Cost, count_cost, mfu, peak_flops
from .memory import (graph_live_bytes, live_array_bytes,
                     live_tensor_bytes, memory_plan, record_live_arrays)
from .numerics import (NumericsMonitor, digest_comm_plan,
                       divergence_check, divergence_digest)
from .compilation import (CompilationLedger, diff_signatures, get_ledger,
                          instrumented_jit, set_ledger)
from .server import ObservabilityServer
from .supervisor import RunSupervisor, SupervisorConfig
from . import (compilation, costmodel, exporters, flightrec, memory,
               metrics, numerics, server, steptime, supervisor, timeline,
               tracing)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DeviceMetrics", "DEFAULT_LATENCY_BUCKETS",
           "get_registry", "set_registry", "SpanRecorder", "span", "event",
           "maybe_span", "maybe_event", "get_recorder", "set_recorder",
           "new_trace_id", "EventRing", "get_ring", "set_ring",
           "SCHEMA_VERSION", "JsonlExporter", "prometheus_text",
           "host_info", "validate_bench_record", "validate_bench_jsonl",
           "Cost", "count_cost", "peak_flops", "mfu",
           "memory_plan", "graph_live_bytes", "live_array_bytes",
           "live_tensor_bytes", "record_live_arrays",
           "NumericsMonitor", "divergence_check", "divergence_digest",
           "digest_comm_plan",
           "CompilationLedger", "instrumented_jit", "diff_signatures",
           "get_ledger", "set_ledger",
           "ObservabilityServer", "RunSupervisor", "SupervisorConfig",
           "metrics", "tracing", "flightrec", "steptime", "timeline",
           "exporters", "costmodel", "memory", "numerics", "server",
           "supervisor", "compilation"]
