"""Span/event recorder: wall-clock ranges → Chrome trace / JSONL,
plus the request-scoped distributed-trace context the fleet layer
propagates (the flight recorder's causal spine).

Counterpart of ``apex_tpu/observability/tracing.py``, copied (it is
stdlib code).  Layered on ``apex_tpu_torch.utils.profiler``: every
:meth:`SpanRecorder.span` also opens the profiler's range
(``torch.profiler.record_function`` and, with a GPU, an NVTX range), so
a span shows up in ``torch.profiler`` captures *and* in this recorder's
exportable timeline.  The recorder itself is pure host-side
bookkeeping — a span around a CUDA-graph capture times only the
capture, so put spans around eager sections: admission, harvest,
checkpointing, data loading.

**Trace context.**  Every span/event carries a recorder-allocated
``span_id`` (monotonic under the recorder lock, so allocation order IS
causal order: a child's id is always greater than its parent's).  A
*trace* groups spans end-to-end across components and threads:

- :func:`new_trace_id` mints a process-unique trace id (``Fleet.submit``
  mints one per request);
- the *ambient* context is a :class:`contextvars.ContextVar`, so it is
  **per-thread-of-execution**: a span opened on one thread can never
  adopt a parent another thread happens to have open (without it,
  worker-thread spans would interleave freely);
- :meth:`SpanRecorder.span` reads the ambient context for its trace and
  parent unless given explicit ``trace_id=`` / ``parent_id=``, and
  installs itself as the ambient parent for the enclosed block;
- :meth:`SpanRecorder.activate` installs a (trace_id, span_id) pair as
  the ambient context *without* recording anything — how the fleet
  hands a worker thread the dispatch span to parent engine-internal
  spans under (``ThreadPoolExecutor`` workers start with an empty
  context and are reused, so the context must be scoped; the token
  reset in ``finally`` guarantees no leakage between pool tasks).

**Tenant attribution.**  Attrs ride into each event's ``args``
verbatim, and the fleet uses exactly that: a tagged request's
``tenant`` / ``priority`` are stamped on EVERY span and event of its
trace (submit, route, dispatch, engine queue/prefill, finish — and
the failure hops: fault, reclaim, re-dispatch after failover), so
filtering a Chrome trace or a ``trace_record`` by ``args.tenant``
yields one tenant's complete story with no joins.  The recorder adds
no tenant-specific machinery — the contract is the *stamping
discipline* in ``fleet.Fleet._trace_ev``, pinned by tests.

Exports:

- **Chrome trace JSON** (``chrome://tracing`` / Perfetto): complete
  events (``ph: "X"``, microsecond timestamps) plus instant events.
- **JSONL event log**: one JSON object per event, machine-readable for
  downstream analysis (the bench/CI side of the telemetry trail).
- **Trace records** (:meth:`SpanRecorder.trace_record`): one
  schema-versioned ``kind: trace`` object per trace id, validated by
  ``exporters.validate_trace_record`` — the per-request flight record.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["SpanRecorder", "get_recorder", "set_recorder", "span",
           "event", "export_chrome_trace", "export_jsonl",
           "new_trace_id", "current_trace", "maybe_span", "maybe_event",
           "DEFAULT_MAX_EVENTS"]

# ambient (recorder, trace_id, span_id) of the innermost open span/
# activation on THIS thread of execution; contextvars give each thread
# its own slot.  The owning RECORDER rides along because span ids are
# per-recorder: an ambient parent minted by one recorder must never be
# adopted into another recorder's id space (dangling/colliding
# parent_ids) — maybe_span/maybe_event record into the ambient
# recorder, and _resolve only adopts a context it owns.
_CURRENT: contextvars.ContextVar[
    Optional[Tuple["SpanRecorder", str, Optional[int]]]] = \
    contextvars.ContextVar("apex_tpu_trace", default=None)

_trace_lock = threading.Lock()
_trace_counter = 0


def new_trace_id(prefix: str = "t") -> str:
    """Process-unique trace id (``t-<pid>-<n>``): cheap, ordered, and
    readable in artifacts — no uuid dependency, and the counter makes
    ids deterministic per process for test pinning."""
    global _trace_counter
    with _trace_lock:
        _trace_counter += 1
        n = _trace_counter
    return f"{prefix}-{os.getpid():x}-{n:x}"


def current_trace() -> Optional[Tuple[str, Optional[int]]]:
    """The ambient ``(trace_id, span_id)`` of this thread, or None —
    the gate :func:`maybe_span` uses so untraced hot paths record
    nothing."""
    cur = _CURRENT.get()
    return None if cur is None else (cur[1], cur[2])


class SpanRecorder:
    """Thread-safe span/event buffer with a per-recorder time origin.

    ``max_events`` bounds the buffer (oldest events drop first) — the
    flight-recorder discipline for long-running processes; ``None``
    keeps every event (short captures)."""

    def __init__(self, clock=time.perf_counter,
                 max_events: Optional[int] = None):
        self._clock = clock
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._t0 = clock()
        self._pid = os.getpid()
        self._next_span = 0

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _alloc_span(self) -> int:
        """Next span id, allocated under the lock at span ENTRY, so ids
        are causally ordered: a child (entered after its parent) always
        carries a larger id than the parent."""
        with self._lock:
            self._next_span += 1
            return self._next_span

    def _resolve(self, trace_id, parent_id):
        """Fill trace/parent from the ambient context when not given
        explicitly.  An explicit ``trace_id`` with no ``parent_id``
        stays parentless (a new root) — it must NOT adopt whatever
        span another trace has open on this thread.  A context owned
        by a DIFFERENT recorder is never adopted either: its span ids
        live in that recorder's id space."""
        if trace_id is None:
            cur = _CURRENT.get()
            if cur is not None and cur[0] is self:
                trace_id = cur[1]
                if parent_id is None:
                    parent_id = cur[2]
        return trace_id, parent_id

    def _stamp(self, ev, trace_id, span_id, parent_id):
        ev["span_id"] = span_id
        if trace_id is not None:
            ev["trace_id"] = trace_id
        if parent_id is not None:
            ev["parent_id"] = parent_id
        return ev

    @contextlib.contextmanager
    def span(self, name: str, trace_id: Optional[str] = None,
             parent_id: Optional[int] = None, **attrs):
        """Record a complete event for the enclosed block; also opens
        the profiler range so a profiler capture matches this timeline.
        Exception-safe and nestable (nesting renders as stacked slices
        in the Chrome trace viewer).  While the block runs, this span
        is the ambient parent for spans/events opened on the SAME
        thread of execution; the context token is reset in ``finally``
        so reused pool threads never inherit a stale parent."""
        from ..utils import profiler
        tid = threading.get_ident()
        trace_id, parent_id = self._resolve(trace_id, parent_id)
        span_id = self._alloc_span()
        token = _CURRENT.set((self, trace_id, span_id)) \
            if trace_id is not None else None
        begin = self._now_us()
        # the token reset must be unconditional: if even the profiler
        # range fails to OPEN, a reused pool thread must not keep this
        # span as its ambient parent
        try:
            with profiler.nvtx_range(name):
                yield self
        finally:
            if token is not None:
                _CURRENT.reset(token)
            end = self._now_us()
            ev = {"name": name, "ph": "X", "ts": begin,
                  "dur": max(end - begin, 0.0),
                  "pid": self._pid, "tid": tid}
            self._stamp(ev, trace_id, span_id, parent_id)
            if attrs:
                ev["args"] = dict(attrs)
            with self._lock:
                self._events.append(ev)

    def event(self, name: str, trace_id: Optional[str] = None,
              parent_id: Optional[int] = None, **attrs) -> int:
        """Instant (zero-duration) event — loss-scale changes, engine
        admissions, flush points, request-lifecycle transitions.
        Returns the event's span id so callers chaining a causal
        lifecycle (submit → route → dispatch → …) can parent the next
        hop on this one."""
        trace_id, parent_id = self._resolve(trace_id, parent_id)
        span_id = self._alloc_span()
        ev = {"name": name, "ph": "i", "s": "t", "ts": self._now_us(),
              "pid": self._pid, "tid": threading.get_ident()}
        self._stamp(ev, trace_id, span_id, parent_id)
        if attrs:
            ev["args"] = dict(attrs)
        with self._lock:
            self._events.append(ev)
        return span_id

    @contextlib.contextmanager
    def activate(self, trace_id: str, span_id: Optional[int] = None):
        """Install ``(trace_id, span_id)`` as this thread's ambient
        context WITHOUT recording anything.  The cross-thread handoff:
        the fleet step pool activates the request/replica context in
        the worker so engine-internal spans parent correctly."""
        token = _CURRENT.set((self, trace_id, span_id))
        try:
            yield self
        finally:
            _CURRENT.reset(token)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def clear(self):
        with self._lock:
            self._events.clear()

    # -- trace queries -----------------------------------------------------
    def trace_ids(self) -> List[str]:
        """Distinct trace ids with at least one retained event, in
        first-seen order — the ``/tracez`` index (a bounded recorder
        lists only traces whose events survived eviction)."""
        seen: Dict[str, None] = {}
        for e in self.events():
            tid = e.get("trace_id")
            if tid is not None and tid not in seen:
                seen[tid] = None
        return list(seen)

    def trace(self, trace_id: str) -> List[Dict[str, Any]]:
        """All events of one trace, in span-id (causal allocation)
        order — begin-time order would interleave a parent span (whose
        complete event is appended at EXIT) after its children."""
        evs = [e for e in self.events() if e.get("trace_id") == trace_id]
        evs.sort(key=lambda e: e["span_id"])
        return evs

    def trace_record(self, trace_id: str) -> Dict[str, Any]:
        """The ``kind: trace`` JSONL record for one trace (feed it
        through ``JsonlExporter``/``enrich`` for the envelope;
        ``exporters.validate_trace_record`` pins the shape)."""
        spans = self.trace(trace_id)
        return {"kind": "trace", "trace_id": trace_id,
                "spans": spans, "span_count": len(spans)}

    # -- exports -----------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (traceEvents array form)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)
        return path

    def export_jsonl(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev) + "\n")
        os.replace(tmp, path)
        return path


# the process default is BOUNDED (flight-recorder discipline): a fleet
# traces every request by default, and a process that serves for weeks
# must hold the last DEFAULT_MAX_EVENTS spans — not all of them.  Old
# traces evict oldest-first; a trace whose head was evicted no longer
# validates as a complete ``kind: trace`` record (the validator flags
# the missing parent), which is the honest answer.  Install
# ``set_recorder(SpanRecorder())`` for an unbounded short capture.
DEFAULT_MAX_EVENTS = 65536

_global_recorder = SpanRecorder(max_events=DEFAULT_MAX_EVENTS)


def get_recorder() -> SpanRecorder:
    return _global_recorder


def set_recorder(recorder: SpanRecorder) -> SpanRecorder:
    global _global_recorder
    prev, _global_recorder = _global_recorder, recorder
    return prev


def span(name: str, **attrs):
    """``with observability.span("checkpoint_save"): ...`` on the
    process-wide default recorder."""
    return _global_recorder.span(name, **attrs)


def event(name: str, **attrs):
    return _global_recorder.event(name, **attrs)


@contextlib.contextmanager
def maybe_span(name: str, **attrs):
    """Span ONLY when a trace context is ambient on this thread;
    otherwise a no-op.  Records into the recorder that OWNS the
    ambient context (its parent span ids live in that recorder's id
    space), which is the default recorder on the normal fleet path.
    The engine hot paths (queue/prefill/window-decode) use this so a
    standalone engine with no fleet trace records nothing per step —
    tracing costs are opt-in per request, and an untraced process's
    recorder never grows."""
    cur = _CURRENT.get()
    if cur is None:
        yield None
        return
    with cur[0].span(name, **attrs) as rec:
        yield rec


def maybe_event(name: str, **attrs) -> Optional[int]:
    """Ambient-gated instant event (see :func:`maybe_span`)."""
    cur = _CURRENT.get()
    if cur is None:
        return None
    return cur[0].event(name, **attrs)


def export_chrome_trace(path: str,
                        recorder: Optional[SpanRecorder] = None) -> str:
    return (recorder or _global_recorder).export_chrome_trace(path)


def export_jsonl(path: str,
                 recorder: Optional[SpanRecorder] = None) -> str:
    return (recorder or _global_recorder).export_jsonl(path)
