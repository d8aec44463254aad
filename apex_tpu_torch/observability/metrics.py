"""Metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``apex_tpu/observability/metrics.py``'s host metrics,
copied (they are stdlib code): :class:`Counter`, :class:`Gauge` and
:class:`Histogram` owned by a :class:`MetricsRegistry`, thread-safe
Python accumulation for eager-path instrumentation such as the serving
engines' step latency.  The JAX package's ``DeviceMetrics`` (counters
carried inside a jitted training step) is not ported yet: ROADMAP.md
queue 1, item 9.

Histograms are Prometheus-shaped: fixed upper-bound bucket edges with
``le`` (<=) semantics, a running sum, and a total count; the exporter
emits the cumulative form.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry",
           "DEFAULT_LATENCY_BUCKETS", "DEFAULT_MAX_LABEL_SETS",
           "OVERFLOW_LABEL_VALUE"]

# seconds; spans sub-ms kernel dispatches to multi-second compiles
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# cardinality cap: at most this many distinct label sets per metric.
# Label values can be user-supplied strings (tenant ids on the fleet
# serving path) — an unbounded child dict is an OOM with extra steps.
# Past the cap, new label sets fold into a shared overflow child whose
# values are all OVERFLOW_LABEL_VALUE, and the fold is counted on
# ``labels_dropped`` so the totals stay conserved AND accounted.
DEFAULT_MAX_LABEL_SETS = 64
OVERFLOW_LABEL_VALUE = "other"


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[Tuple, "_Metric"] = {}
        self.max_label_sets = DEFAULT_MAX_LABEL_SETS
        self._labels_dropped = 0

    def _new_child(self):
        return type(self)(self.name, self.help)

    def labels(self, **labels):
        """Child metric for a label set (e.g. per-dtype comm counters);
        children are exported under the parent's name with the labels.

        Distinct label sets are capped at ``max_label_sets``: once full,
        an unseen set folds into the shared overflow child (every value
        replaced by ``OVERFLOW_LABEL_VALUE``) and ``labels_dropped``
        counts the fold — the increments still land somewhere exported,
        but a flood of user-supplied values (tenant ids) cannot grow
        the registry without bound."""
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_label_sets:
                    self._labels_dropped += 1
                    key = tuple((k, OVERFLOW_LABEL_VALUE)
                                for k, _ in key)
                    child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    child._label_set = key
                    self._children[key] = child
            return child

    @property
    def labels_dropped(self) -> int:
        """Label sets folded into the overflow child so far."""
        with self._lock:
            return self._labels_dropped

    def children(self):
        with self._lock:
            return dict(self._children)


class Counter(_Metric):
    """Monotonic counter."""
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0

    def inc(self, value: float = 1.0):
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {value})")
        with self._lock:
            self._value += value

    def set_total(self, value: float):
        """Overwrite with an externally-accumulated monotonic total —
        the DeviceMetrics flush path (device counters already hold the
        total; adding would double-count repeated flushes)."""
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time value."""
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, value: float = 1.0):
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram with Prometheus ``le`` (<=) edge semantics:
    an observation exactly on an edge lands in that edge's bucket."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help)
        edges = tuple(float(e) for e in buckets)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name} buckets must be strictly "
                             f"increasing, got {buckets}")
        if not edges:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.edges = edges
        # per-bucket (non-cumulative) counts; last slot is the +Inf
        # overflow bucket
        self._counts = [0] * (len(edges) + 1)
        self._sum = 0.0
        self._count = 0
        # summary() memo, invalidated by every write: Engine.stats()
        # builds five summaries per read and routers/fleets read stats
        # far more often than engines observe, so recomputing the
        # bucket-walk quantiles on every read would dominate a read.
        # _summary_computes counts actual recomputes (test pin).
        self._summary_cache: Optional[Dict[str, Any]] = None
        self._summary_computes = 0

    def _new_child(self):
        return Histogram(self.name, self.help, self.edges)

    def observe(self, value: float):
        idx = bisect.bisect_left(self.edges, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            self._summary_cache = None

    def _restore(self, counts: Sequence[float], total: float):
        """Overwrite from externally-accumulated totals (DeviceMetrics
        flush); ``counts`` is per-bucket non-cumulative incl. overflow."""
        if len(counts) != len(self._counts):
            raise ValueError(
                f"histogram {self.name} expects {len(self._counts)} "
                f"bucket counts, got {len(counts)}")
        with self._lock:
            self._counts = [int(c) for c in counts]
            self._count = sum(self._counts)
            self._sum = float(total)
            self._summary_cache = None

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> Dict[str, int]:
        """{le_edge_or_'+Inf': cumulative count} — the exposition form."""
        with self._lock:
            out, acc = {}, 0
            for e, c in zip(self.edges, self._counts):
                acc += c
                out[repr(e)] = acc
            out["+Inf"] = acc + self._counts[-1]
            return out

    def _percentile_locked(self, q: float) -> Optional[float]:
        # caller holds self._lock
        if self._count == 0:
            return None
        target = q * self._count
        acc, lo = 0.0, 0.0
        for e, c in zip(self.edges, self._counts):
            if acc + c >= target and c > 0:
                frac = (target - acc) / c
                return lo + frac * (e - lo)
            acc += c
            lo = e
        return self.edges[-1]

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (q in [0, 1]); None when
        empty.  Values past the last edge clamp to it — fixed buckets
        cannot resolve the overflow tail."""
        with self._lock:
            return self._percentile_locked(q)

    def summary(self) -> Dict[str, Any]:
        """{count, sum, mean, p50, p99}.  Memoized between writes: a
        read-heavy consumer (``Engine.stats()`` under a fleet router)
        pays the two bucket walks once per observation, not once per
        read."""
        with self._lock:
            if self._summary_cache is None:
                count, total = self._count, self._sum
                self._summary_cache = {
                    "count": count, "sum": total,
                    "mean": (total / count) if count else None,
                    "p50": self._percentile_locked(0.5),
                    "p99": self._percentile_locked(0.99)}
                self._summary_computes += 1
            return dict(self._summary_cache)


class MetricsRegistry:
    """Named metric store; ``counter``/``gauge``/``histogram`` are
    get-or-create (a kind clash on an existing name raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, Any]:
        """Plain-python view: counters/gauges as numbers, histograms as
        their summary dict."""
        out = {}
        for m in self.collect():
            out[m.name] = (m.summary() if isinstance(m, Histogram)
                           else m.value)
        return out

    def clear(self):
        with self._lock:
            self._metrics.clear()


_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (DDP comm accounting, data
    loader timings, and DeviceMetrics flushes land here unless given an
    explicit registry)."""
    return _global_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _global_registry
    prev, _global_registry = _global_registry, registry
    return prev

