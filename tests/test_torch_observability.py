"""The port's observability modules (``apex_tpu_torch.observability``,
stdlib copies of the JAX package's metrics and tracing) against the JAX
package's: the same observations give the same counters, gauges,
histogram summaries and snapshots; spans and events record the same
trace structure."""

import numpy as np
import pytest

from apex_tpu.observability import metrics as jmetrics
from apex_tpu.observability import tracing as jtracing

from apex_tpu_torch import observability
from apex_tpu_torch.observability import metrics, tracing


def _observe(mod, values, buckets=None):
    reg = mod.MetricsRegistry()
    h = (reg.histogram("lat", help="x") if buckets is None
         else reg.histogram("lat", buckets=buckets, help="x"))
    for v in values:
        h.observe(v)
    reg.counter("n").inc(3)
    reg.counter("n").inc()
    reg.gauge("g").set(2.5)
    lab = reg.counter("by_tenant", help="y")
    lab.labels(tenant="a").inc(2)
    lab.labels(tenant="b").inc()
    return reg, h


@pytest.mark.parametrize("buckets", [None, (1.0, 2.0, 5.0, 10.0)])
def test_same_observations_same_summary(buckets):
    values = list(np.random.RandomState(0).exponential(0.05, 200)) + [
        0.0, 1e-9, 7.0, 100.0]
    jreg, jh = _observe(jmetrics, values, buckets)
    treg, th = _observe(metrics, values, buckets)
    assert th.summary() == jh.summary()
    assert treg.snapshot() == jreg.snapshot()
    assert treg.counter("n").value == 4.0
    assert observability.MetricsRegistry is metrics.MetricsRegistry


def test_global_registry_swap():
    prev = metrics.get_registry()
    mine = metrics.MetricsRegistry()
    assert metrics.set_registry(mine) is prev
    assert metrics.get_registry() is mine
    metrics.set_registry(prev)


def test_spans_and_events_match():
    out = {}
    for name, mod in (("jax", jtracing), ("port", tracing)):
        rec = mod.SpanRecorder()
        tid = mod.new_trace_id()
        with rec.span("outer", trace_id=tid, a=1):
            with rec.span("inner", b=2):
                rec.event("mark", c=3)
        # maybe_* record nothing without an ambient trace
        assert mod.maybe_event("quiet") is None
        with mod.maybe_span("quiet"):
            pass
        evs = rec.events()
        out[name] = [(e["name"], e["ph"], e.get("args"),
                      e.get("parent_id") is not None) for e in evs]
        assert {e.get("trace_id") for e in evs} == {tid}
    assert out["port"] == out["jax"]
