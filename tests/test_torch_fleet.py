"""``apex_tpu_torch.fleet`` against the JAX package's ``apex_tpu.fleet``,
on the CPU.

Two layers, as in tests/test_fleet.py, the parity spec:

- the orchestration (routing policies, backpressure and shed, retries
  with backoff, the breaker's open → half-open → closed and its doubled
  cooldown, the stall watchdog, drain and undrain, deadlines, prefix
  ownership, tracing, SLO and tenant accounting) drives a JAX ``Fleet``
  and a port ``Fleet`` over identical stub replicas
  (``tests/torch_fleet_util.py``) under one injected tick clock.  Every
  request's outcome, ``stats()``, ``record()``, the ring's events and
  the metrics are equal, latencies included; each scenario also keeps
  the JAX test's own assertions;
- the engines: fleets of the port's ``Engine`` and ``PagedEngine`` at the
  JAX serving tests' model (a GPT of vocab 64, block 24, 2 layers, 4
  heads, width 32, 2 KV heads; one set of weights in both packages),
  fp32.  Greedy tokens equal the JAX fleet's exactly, through failover;
  a sampled request (the port's own stream) equals the port's single
  engine; ``step_workers`` 1 and 2 give identical results; a replica
  whose step may capture a graph never shares the pool.

Plus the launch counters under threads, and the package's imports.
"""

import json
import os
import re
import threading
import time

import numpy as np
import pytest

from apex_tpu import fleet as jfleet
from apex_tpu import serving as jserving

from apex_tpu_torch import ops, serving
from apex_tpu_torch import observability as obs
from apex_tpu_torch.fleet import (FaultyReplica, Fleet, HealthConfig,
                                  LeastLoaded, PrefixAffinity,
                                  RetryPolicy, RoundRobin, make_policy)

import torch_serving_util as su
from torch_fleet_util import (StubReplica, TickClock, drive, observe,
                              package, twin)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ring(pk, clock, capacity=64):
    return pk.obs.EventRing(capacity=capacity, clock=clock)


# -- the orchestration, twinned over stub replicas ---------------------------

def _policies(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    fl = F.Fleet([StubReplica(), StubReplica(), StubReplica()],
                 policy="round_robin", step_workers=1, clock=clk, ring=ring)
    rids = [fl.submit([1, 2], max_new_tokens=2) for _ in range(3)]
    fl.step()
    spread = [r.live() + len(r._finished) for r in fl.replicas]
    assert spread == [1, 1, 1]
    a, b = StubReplica(slots=4), StubReplica(slots=4)
    fl2 = F.Fleet([a, b], policy="least_loaded", step_workers=1, clock=clk,
                  ring=ring)
    a._free = [0]
    a._live = {100 + i: [[1], 1, []] for i in range(3)}
    fl2.submit([1, 2, 3], max_new_tokens=1)
    fl2.step()
    assert b.live() + len(b._finished) == 1
    drive(fl, clock=clk)
    return observe(fl, rids, ring)


def _shed(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    fl = F.Fleet([StubReplica(slots=1)], max_queue=2, replica_queue_cap=0,
                 step_workers=1, clock=clk, ring=ring)
    rids = [fl.submit([1], max_new_tokens=50)]
    fl.step()
    rids += [fl.submit([1, 2], max_new_tokens=1),
             fl.submit([1, 2, 3], max_new_tokens=1)]
    with pytest.raises(F.FleetOverloaded) as ei:
        fl.submit([1, 2, 3, 4], max_new_tokens=1)
    assert ei.value.queue_depth == 2 and ei.value.max_queue == 2
    for _ in range(5):
        with pytest.raises(F.FleetOverloaded):
            fl.submit([9], max_new_tokens=1)
    assert fl.stats()["shed"] == 6
    assert len(ring.snapshot("shed")) == 1
    drive(fl, clock=clk)
    rids.append(fl.submit([1, 2, 3, 4], max_new_tokens=1))
    drive(fl, clock=clk)
    rids.append(fl.submit([1], max_new_tokens=50))
    fl.step()
    rids += [fl.submit([1, 2], max_new_tokens=1),
             fl.submit([1, 2, 3], max_new_tokens=1)]
    with pytest.raises(F.FleetOverloaded):
        fl.submit([7, 7], max_new_tokens=1)
    assert len(ring.snapshot("shed")) == 2
    drive(fl, clock=clk)
    return observe(fl, rids, ring)


def _default_ring_swap(pk):
    F = pk.fleet
    clk = TickClock()
    rep = F.FaultyReplica(StubReplica(), raise_on_step=(0, 1))
    fl = F.Fleet([rep, StubReplica()], policy="round_robin",
                 health=F.HealthConfig(dead_consecutive=1,
                                       cooldown_steps=100),
                 retry=F.RetryPolicy(max_attempts=6, jitter=0.0),
                 step_workers=1, clock=clk)
    fresh = _ring(pk, clk)
    prev = pk.obs.set_ring(fresh)
    try:
        rids = [fl.submit([1, 2], max_new_tokens=2)]
        drive(fl, clock=clk)
        assert fl.stats()["failovers"] == 1
        kinds = {e["kind"] for e in fresh.snapshot()}
        assert {"fault_injected", "failover", "breaker_open"} <= kinds
        return observe(fl, rids, fresh)
    finally:
        pk.obs.set_ring(prev)


def _retry_backoff(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    rep = F.FaultyReplica(StubReplica(), raise_on_prefill=(0, None),
                          ring=ring)
    fl = F.Fleet([rep], retry=F.RetryPolicy(max_attempts=5,
                                            base_delay_steps=1,
                                            backoff=2.0, jitter=0.0),
                 step_workers=1, clock=clk, ring=ring)
    rid = fl.submit([1, 2], max_new_tokens=2)
    for _ in range(4):
        fl.step()
        clk.t += 1.0
    assert fl.status(rid) == "queued"
    assert fl._pending[0].next_attempt_step > fl._step_no
    rep._raise_on_prefill = ()
    drive(fl, limit=40, clock=clk)
    assert fl.result(rid) == StubReplica.expected([1, 2], 2)
    return observe(fl, [rid], ring)


def _retry_exhaustion(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    rep = F.FaultyReplica(StubReplica(), raise_on_prefill=(0, None),
                          ring=ring)
    fl = F.Fleet([rep], retry=F.RetryPolicy(max_attempts=2, jitter=0.0),
                 step_workers=1, clock=clk, ring=ring)
    rid = fl.submit([1], max_new_tokens=1)
    for _ in range(6):
        fl.step()
        clk.t += 1.0
    assert fl.status(rid) == "failed"
    with pytest.raises(RuntimeError, match="dispatch failed after 2"):
        fl.result(rid)

    class _Picky(StubReplica):
        def submit(self, prompt, *a, **kw):
            raise ValueError("prompt length bad")

    fl2 = F.Fleet([_Picky()], step_workers=1, clock=clk, ring=ring)
    bad = fl2.submit([1] * 99, max_new_tokens=1)
    fl2.step()
    with pytest.raises(RuntimeError, match="rejected at dispatch"):
        fl2.result(bad)
    assert fl2.health[0].errors_total == 0
    return {"a": observe(fl, [rid], ring), "b": observe(fl2, [bad], ring)}


def _breaker(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    rep = F.FaultyReplica(StubReplica(), raise_on_step=(0, 2), ring=ring)
    fl = F.Fleet([rep], health=F.HealthConfig(dead_consecutive=2,
                                              cooldown_steps=4),
                 retry=F.RetryPolicy(max_attempts=10, jitter=0.0),
                 step_workers=1, clock=clk, ring=ring)
    rid = fl.submit([1, 2, 3], max_new_tokens=4)
    fl.step()
    assert fl.states()[0] != F.DEAD
    fl.step()
    assert fl.states() == [F.DEAD] and fl.health[0].circuit == "open"
    before = rep.steps
    for _ in range(3):
        fl.step()
    assert rep.steps == before and fl.health[0].circuit == "open"
    fl.step()
    assert rep.steps == before + 1 and fl.health[0].circuit == "closed"
    drive(fl, limit=20, clock=clk)
    assert fl.states() == [F.HEALTHY]
    assert fl.result(rid) == StubReplica.expected([1, 2, 3], 4)
    assert fl.stats()["failovers"] == 2
    return observe(fl, [rid], ring)


def _half_open_probe(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    rep = F.FaultyReplica(StubReplica(), raise_on_step=(0, 1), ring=ring)
    fl = F.Fleet([rep, StubReplica(slots=8)], policy="least_loaded",
                 health=F.HealthConfig(dead_consecutive=1, cooldown_steps=2),
                 retry=F.RetryPolicy(max_attempts=10, jitter=0.0),
                 step_workers=1, clock=clk, ring=ring)
    rids = [fl.submit([1], max_new_tokens=2) for _ in range(2)]
    fl.step()
    assert fl.states()[0] == F.DEAD
    recovered = None
    for i in range(10):
        rids.append(fl.submit([2, 3], max_new_tokens=1))
        fl.step()
        clk.t += 1.0
        if fl.health[0].circuit == "closed":
            recovered = i
            break
    assert recovered is not None
    drive(fl, limit=40, clock=clk)
    assert fl.stats()["failed"] == 0
    return observe(fl, rids, ring)


def _doubled_cooldown(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    rep = F.FaultyReplica(StubReplica(), raise_on_step=(0, 3), ring=ring)
    fl = F.Fleet([rep], health=F.HealthConfig(dead_consecutive=2,
                                              cooldown_steps=2,
                                              cooldown_backoff=2.0),
                 retry=F.RetryPolicy(max_attempts=20, jitter=0.0),
                 step_workers=1, clock=clk, ring=ring)
    rid = fl.submit([1], max_new_tokens=2)
    for _ in range(2):
        fl.step()
    assert fl.health[0].circuit == "open"
    fl.step()
    fl.step()
    assert fl.health[0].circuit == "open"
    assert fl.health[0]._cooldown == 4
    drive(fl, limit=40, clock=clk)
    assert fl.stats()["finished"] == 1
    return observe(fl, [rid], ring)


def _stall_watchdog(pk):
    F = pk.fleet
    out = {}
    for kind, n in (("stall", 3), ("drop_results", 8)):
        clk = TickClock()
        ring = _ring(pk, clk)
        sick = F.FaultyReplica(StubReplica(), ring=ring,
                               **{kind: (0, None)})
        fl = F.Fleet([sick, StubReplica()], policy="round_robin",
                     health=F.HealthConfig(stall_steps=3,
                                           dead_consecutive=2),
                     retry=F.RetryPolicy(max_attempts=6, jitter=0.0),
                     step_workers=1, clock=clk, ring=ring)
        rids = [fl.submit([1, 2], max_new_tokens=n) for _ in range(2)]
        drive(fl, limit=80, clock=clk)
        assert all(fl.result(r) == StubReplica.expected([1, 2], n)
                   for r in rids)
        assert fl.stats()["failovers"] >= 1
        out[kind] = observe(fl, rids, ring)
    return out


def _arm_and_close(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    rep = F.FaultyReplica(StubReplica(), ring=ring)
    fl = F.Fleet([rep, StubReplica()], policy="round_robin",
                 health=F.HealthConfig(dead_consecutive=2),
                 retry=F.RetryPolicy(max_attempts=6, jitter=0.0),
                 clock=clk, ring=ring)
    rids = [fl.submit([1], max_new_tokens=2) for _ in range(2)]
    drive(fl, clock=clk)
    assert rep.faults_fired == 0 and rep.steps >= 2
    base = rep.steps
    rep.arm(raise_on_step=(1, None))
    assert rep._raise_on_step == ((base + 1, None),)
    rids += [fl.submit([1, 2], max_new_tokens=3) for _ in range(2)]
    drive(fl, limit=80, clock=clk)
    assert rep.faults_fired >= 1
    with pytest.raises(TypeError, match="unknown fault kind"):
        rep.arm(explode=(0, None))
    rep.arm(raise_on_step=())
    fl.close()
    fl.close()
    assert fl._pool is None
    fl.undrain(0)
    rids.append(fl.submit([3], max_new_tokens=1))
    drive(fl, limit=20, clock=clk)
    return observe(fl, rids, ring)


def _drain(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    a, b = StubReplica(slots=1), StubReplica(slots=1)
    fl = F.Fleet([a, b], policy="round_robin", replica_queue_cap=1,
                 step_workers=1, clock=clk, ring=ring)
    rids = [fl.submit([1] * (i + 1), max_new_tokens=4) for i in range(4)]
    fl.step()
    assert a.queue_depth() == 1 and b.queue_depth() == 1
    fl.drain(0)
    assert a.queue_depth() == 0
    assert fl.states()[0] == F.DRAINING and a.live() == 1
    drive(fl, limit=60, clock=clk)
    assert fl.states()[0] == F.DRAINED
    rids.append(fl.submit([9], max_new_tokens=1))
    drive(fl, limit=20, clock=clk)
    assert len(a._finished) == 1
    fl.undrain(0)
    assert fl.states()[0] == F.HEALTHY
    rids += [fl.submit([8], max_new_tokens=1),
             fl.submit([7], max_new_tokens=1)]
    drive(fl, limit=20, clock=clk)
    assert fl.stats()["failed"] == 0
    return observe(fl, rids, ring)


def _deadlines(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    stub = StubReplica(slots=2)
    fl = F.Fleet([stub], clock=clk, replica_queue_cap=0, step_workers=1,
                 ring=ring)
    slow = fl.submit([1], max_new_tokens=100)
    fl.step()
    inflight = fl.submit([1, 2, 3], max_new_tokens=200, deadline=8.0)
    queued = fl.submit([1, 2], max_new_tokens=1, deadline=5.0)
    with pytest.raises(ValueError, match="deadline"):
        fl.submit([1], max_new_tokens=1, deadline=0.0)
    fl.step()
    assert fl.status(inflight) == "inflight"
    assert fl.status(queued) == "queued"
    clk.t = 6.0
    fl.step()
    assert fl.status(queued) == "failed"
    clk.t = 9.0
    fl.step()
    assert fl.status(inflight) == "failed" and stub.live() == 1
    evs = ring.snapshot("deadline_exceeded")
    assert [e["rids"] for e in evs] == [[queued], [inflight]]
    assert fl.status(slow) == "inflight"
    drive(fl, limit=200, clock=clk)
    return observe(fl, [slow, inflight, queued], ring)


def _prefix_owner(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    fl = F.Fleet([StubReplica(), StubReplica()], step_workers=1,
                 policy="prefix_affinity", clock=clk, ring=ring)
    fl._prefix_map[(1, 2)] = 0
    fl._prefix_map[(1, 2, 3)] = 1
    assert fl.prefix_owner([1, 2, 3, 4]) == 1
    assert fl.prefix_owner([1, 2, 9]) == 0
    assert fl.prefix_owner([2, 1]) is None
    assert fl.register_prefix([5, 5, 5]) == 0
    rids = [fl.submit(p, max_new_tokens=2)
            for p in ([1, 2, 3, 4], [1, 2, 9], [5, 5, 5, 1], [7])]
    drive(fl, clock=clk)
    return observe(fl, rids, ring)


def _record_and_gauges(pk):
    F, E = pk.fleet, pk.exporters
    clk = TickClock()
    ring = _ring(pk, clk)
    fl = F.Fleet([StubReplica(), StubReplica()], step_workers=1, clock=clk,
                 ring=ring)
    rids = [fl.submit([1, 2], max_new_tokens=2) for _ in range(3)]
    drive(fl, clock=clk)
    rec = E.JsonlExporter.enrich(fl.record())
    assert E.validate_fleet_record(rec) == []
    assert E.validate_telemetry_record(rec) == []
    st = fl.metrics.gauge("fleet_replica_state_code")
    assert set(st.children()) == {(("replica", "0"),), (("replica", "1"),)}
    return observe(fl, rids, ring)


def _slo_goodput(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    fl = F.Fleet([StubReplica(slots=4)], clock=clk, step_workers=1,
                 ring=ring)
    rids = [fl.submit([1, 2], max_new_tokens=3, deadline=100.0),
            fl.submit([1, 2], max_new_tokens=3, deadline=100.0),
            fl.submit([1, 2], max_new_tokens=3),
            fl.submit([1, 2], max_new_tokens=3, deadline=4.0)]
    clk.t = 5.0
    drive(fl, limit=50, clock=clk)
    s = fl.stats()
    assert s["slo"]["with_deadline"] == 3
    assert s["slo"]["within_deadline"] == 2
    assert s["slo"]["goodput_tokens"] == 9
    assert s["deadline_last_sweep"]["rids"] == [rids[3]]
    assert fl.metrics.get("fleet_slo_miss_total").value == 1
    return observe(fl, rids, ring)


def _failed_dispatch_slo_miss(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)

    class _Rejecting(StubReplica):
        def submit(self, prompt, *a, **kw):
            raise ValueError("seeded shape rejection")

    fl = F.Fleet([_Rejecting()], step_workers=1, clock=clk, ring=ring)
    rids = [fl.submit([1], max_new_tokens=1, deadline=100.0),
            fl.submit([1], max_new_tokens=1)]
    fl.step()
    s = fl.stats()["slo"]
    assert s["with_deadline"] == 1 and s["slo_attainment"] == 0.0
    return observe(fl, rids, ring)


def _tenants_under_concurrency(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    fl = F.Fleet([StubReplica(slots=1), StubReplica(slots=1)], max_queue=2,
                 replica_queue_cap=0, step_workers=2, clock=clk, ring=ring)
    rids = [fl.submit([1], max_new_tokens=6, tenant="acme"),
            fl.submit([1, 2], max_new_tokens=6, tenant="zeta")]
    fl.step()
    clk.t += 1.0
    rids += [fl.submit([1], max_new_tokens=1, deadline=2.0, tenant="acme"),
             fl.submit([1, 2], max_new_tokens=1, deadline=2.0,
                       tenant="zeta")]
    for tn in ("acme", "acme", "zeta"):
        with pytest.raises(F.FleetOverloaded):
            fl.submit([9], max_new_tokens=1, tenant=tn)
    clk.t = 5.0
    drive(fl, limit=50, clock=clk)
    s = fl.stats()
    for key, total in (("shed", s["shed"]),
                       ("deadline_exceeded", s["deadline_exceeded"]),
                       ("goodput_tokens", s["slo"]["goodput_tokens"]),
                       ("submitted", s["submitted"]),
                       ("finished", s["finished"]),
                       ("failed", s["failed"])):
        assert sum(b[key] for b in s["tenants"].values()) == total, key
    fl.close()
    return observe(fl, rids, ring)


def _cardinality_fold(pk):
    F = pk.fleet
    clk = TickClock()
    ring = _ring(pk, clk)
    fl = F.Fleet([StubReplica(slots=4)], step_workers=1, clock=clk,
                 ring=ring)
    fl.slo.max_tenants = 3
    rids = [fl.submit([1, 2], max_new_tokens=2, tenant=f"t{i}")
            for i in range(8)]
    drive(fl, clock=clk)
    s = fl.stats()
    assert sorted(s["tenants"]) == ["other", "t0", "t1", "t2"]
    assert s["tenants_dropped"] == 5
    assert fl.tenant_stats()["label_sets_dropped"] == {}
    return observe(fl, rids, ring)


STUB_SCENARIOS = {f.__name__[1:]: f for f in (
    _policies, _shed, _default_ring_swap, _retry_backoff,
    _retry_exhaustion, _breaker, _half_open_probe, _doubled_cooldown,
    _stall_watchdog, _arm_and_close, _drain, _deadlines, _prefix_owner,
    _record_and_gauges, _slo_goodput, _failed_dispatch_slo_miss,
    _tenants_under_concurrency, _cardinality_fold)}


@pytest.mark.parametrize("name", sorted(STUB_SCENARIOS))
def test_stub_fleet_twin(name):
    twin(STUB_SCENARIOS[name])


def _traced(pk, tenant_tags):
    """The failover trace of tests/test_fleet.py (and, with tags, its
    tenant-survives-failover twin): span names, parent chain and args,
    the ring and the dump, in both packages."""
    F, E = pk.fleet, pk.exporters
    clk = TickClock()
    ring = _ring(pk, clk)
    rec = pk.obs.SpanRecorder()
    prev = pk.obs.set_recorder(rec)
    try:
        bad = F.FaultyReplica(StubReplica(), raise_on_step=(2, None),
                              ring=ring)
        fl = F.Fleet([bad, StubReplica()], policy="round_robin",
                     health=F.HealthConfig(dead_consecutive=1,
                                           cooldown_steps=100),
                     retry=F.RetryPolicy(max_attempts=6, jitter=0.0),
                     step_workers=1, ring=ring, clock=clk)
        kw = [dict(tenant="interactive", priority=0),
              dict(tenant="batch", priority=1)] if tenant_tags else [{}, {}]
        rids = [fl.submit([1, 2, 3], max_new_tokens=6, **kw[0]),
                fl.submit([4, 5], max_new_tokens=3, **kw[1])]
        drive(fl, clock=clk)
        chains = []
        for r in rids:
            evs = rec.trace(fl.request_trace_id(r))
            ids = [e["span_id"] for e in evs]
            chains.append([(e["name"], e.get("args"),
                            ids.index(e["parent_id"])
                            if "parent_id" in e else None) for e in evs])
            tr = E.JsonlExporter.enrich(fl.trace_record(r))
            assert E.validate_trace_record(tr) == []
            assert E.validate_telemetry_record(tr) == []
        names = [c[0] for c in chains[0]]
        assert names == ["fleet_submit", "fleet_route", "fleet_dispatch",
                         "fleet_fault", "fleet_reclaim", "fleet_route",
                         "fleet_dispatch", "fleet_result"]
        assert [c[2] for c in chains[0]] == [None, 0, 1, 2, 3, 4, 5, 6]
        return {**observe(fl, rids, ring), "chains": chains}
    finally:
        pk.obs.set_recorder(prev)


@pytest.mark.parametrize("tenant_tags", [False, True])
def test_failover_trace_twin(tenant_tags):
    got = twin(_traced, tenant_tags)
    assert got["stats"]["failovers"] == 1
    kinds = [e["kind"] for e in got["ring"]]
    assert kinds.index("fault_injected") < kinds.index("failover")
    if tenant_tags:
        (fo,) = [e for e in got["ring"] if e["kind"] == "failover"]
        assert fo["tenants"] == ["interactive"]


def test_flight_dump_on_failover(tmp_path):
    ring = obs.EventRing(capacity=64)
    dump = str(tmp_path / "flight.jsonl")
    bad = FaultyReplica(StubReplica(), raise_on_step=(2, None), ring=ring)
    fl = Fleet([bad, StubReplica()], policy="round_robin",
               health=HealthConfig(dead_consecutive=1, cooldown_steps=100),
               retry=RetryPolicy(max_attempts=6, jitter=0.0),
               step_workers=1, ring=ring, flight_dump_path=dump)
    fl.submit([1, 2, 3], max_new_tokens=6)
    drive(fl)
    with open(dump) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0]["kind"] == "flight_ring" and lines[0]["dropped"] == 0
    assert any(ln["kind"] == "fault_injected" for ln in lines[1:])
    assert any(ln["kind"] == "failover" for ln in lines[1:])


def test_policies_and_validation():
    assert isinstance(make_policy("least_loaded"), LeastLoaded)
    assert isinstance(make_policy("round_robin"), RoundRobin)
    assert isinstance(make_policy("prefix_affinity"), PrefixAffinity)
    with pytest.raises(ValueError, match="unknown routing policy"):
        make_policy("wat")
    with pytest.raises(TypeError, match="select"):
        make_policy(object())
    with pytest.raises(ValueError, match="at least one replica"):
        Fleet([])
    with pytest.raises(ValueError, match="step_workers"):
        Fleet([StubReplica()], step_workers=0)
    # the JAX package's default worker count, on this host
    for n in (1, 2, 3, 16):
        assert Fleet([StubReplica()] * n).step_workers == \
            jfleet.Fleet([StubReplica()] * n).step_workers


def test_retry_policy_jitter_draws_the_jax_packages():
    """The seeded jitter (numpy ``RandomState``) gives the JAX package's
    delays, draw for draw."""
    a = RetryPolicy(max_attempts=9, base_delay_steps=2, backoff=1.5,
                    jitter=0.5, seed=11)
    b = jfleet.RetryPolicy(max_attempts=9, base_delay_steps=2,
                           backoff=1.5, jitter=0.5, seed=11)
    assert [a.delay_steps(k) for k in range(8)] == \
        [b.delay_steps(k) for k in range(8)]


def test_threaded_equals_serial_on_stubs():
    prompts = [[1] * (1 + i % 4) for i in range(8)]
    outs = []
    for workers in (1, 4):
        with Fleet([StubReplica(), StubReplica()],
                   step_workers=workers) as fl:
            rids = [fl.submit(p, max_new_tokens=3) for p in prompts]
            drive(fl)
            outs.append([fl.result(r) for r in rids])
    assert outs[0] == outs[1] == [StubReplica.expected(p, 3)
                                  for p in prompts]


class _Capturing(StubReplica):
    """A stub whose next steps "capture" (its ``uncaptured()`` names a
    graph until it has stepped ``captures`` times), recording which
    other replica steps overlap it."""

    def __init__(self, board, name, captures=0, slots=2):
        super().__init__(slots)
        self.board, self.name, self.left = board, name, captures

    def uncaptured(self):
        return ["engine._chunk_row"] if self.left else []

    def step(self):
        b = self.board
        with b["lock"]:
            b["running"].add(self.name)
            b["max_running"] = max(b["max_running"], len(b["running"]))
            if self.left:
                b["captures"].append(sorted(b["running"]))
        time.sleep(0.02)                 # widen any overlap
        try:
            return super().step()
        finally:
            with b["lock"]:
                b["running"].discard(self.name)
            if self.left:
                self.left -= 1


def test_a_capturing_replica_never_shares_the_pool():
    """The pool steps only replicas whose step cannot capture a graph; a
    replica that names an uncaptured graph steps alone on the fleet
    thread, so no other replica's step is in flight during its capture,
    while the others still overlap on the pool.  Results equal a serial
    run's."""
    results = []
    for workers in (3, 1):
        board = {"lock": threading.Lock(), "running": set(),
                 "max_running": 0, "captures": []}
        reps = [_Capturing(board, "cap", captures=3),
                _Capturing(board, "a"), _Capturing(board, "b")]
        with Fleet(reps, policy="round_robin", step_workers=workers) as fl:
            rids = [fl.submit([1] * (1 + i % 3), max_new_tokens=4)
                    for i in range(6)]
            drive(fl)
            results.append([fl.result(r) for r in rids])
        assert len(board["captures"]) == 3
        assert all(c == ["cap"] for c in board["captures"])
        if workers > 1:
            assert board["max_running"] >= 2     # the pool overlapped
    assert results[0] == results[1]


def test_launch_counts_exact_under_threads():
    """8 threads x 1,000 concurrent ``add_launches`` calls (what the
    step pool's graph replays do) leave exact counts."""
    before = ops.launch_counts()
    go = threading.Barrier(8)

    def work():
        go.wait()
        for _ in range(1000):
            ops.add_launches({"flash_fwd": 1, "layer_norm_fwd": 3})

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    after = ops.launch_counts()
    try:
        assert after["flash_fwd"] - before["flash_fwd"] == 8000
        assert after["layer_norm_fwd"] - before["layer_norm_fwd"] == 24000
        assert all(after[k] == before[k] for k in after
                   if k not in ("flash_fwd", "layer_norm_fwd"))
    finally:
        ops.add_launches({"flash_fwd": 8000, "layer_norm_fwd": 24000}, -1)


def test_the_port_imports_no_jax():
    """Neither the fleet nor the observability modules (nor any other
    module of the port) import jax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|apex_tpu)(\.|\s|$)")
    bad = []
    for root, _, files in os.walk(os.path.join(REPO, "apex_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if pat.match(line):
                            bad.append(f"{path}:{i}: {line.strip()}")
    assert bad == []
    for mod in ("fleet", "health", "router", "qos", "slo", "faults",
                "autoscale", "recovery", "__init__"):
        assert os.path.exists(os.path.join(REPO, "apex_tpu_torch", "fleet",
                                           mod + ".py"))


# -- fleets of engines, fp32, against the JAX package's ----------------------

@pytest.fixture(scope="module")
def gpt():
    return su.gpt(0)


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 64, int(rng.randint(3, 9)))]
            for _ in range(n)]


def _fleet_tokens(fl, prompts, max_new, kws=None):
    rids = [fl.submit(p, max_new_tokens=max_new, **(kws[i] if kws else {}))
            for i, p in enumerate(prompts)]
    drive(fl, limit=300)
    return [[int(t) for t in fl.result(r)] for r in rids], fl.stats()


def test_fleet_of_engines_matches_the_jax_fleet(gpt):
    jm, params, tm = gpt
    prompts = _prompts(0, 5)
    want, js = _fleet_tokens(
        jfleet.Fleet([jserving.Engine(jm, params, slots=2, buf_len=24)
                      for _ in range(2)], policy="least_loaded",
                     step_workers=1), prompts, 6)
    got, s = _fleet_tokens(
        Fleet([serving.Engine(tm, slots=2, buf_len=24) for _ in range(2)],
              policy="least_loaded", step_workers=1), prompts, 6)
    assert got == want
    assert s["finished"] == 5 and s["failed"] == 0 and s["healthy"] == 2
    for k in ("submitted", "finished", "tokens_generated", "failovers"):
        assert s[k] == js[k]


def test_failover_mid_decode_matches_the_jax_fleet(gpt):
    """A seeded fault kills replica 0 after its 3rd step; every result is
    the JAX fleet's, and the single engine's."""
    jm, params, tm = gpt
    prompts = _prompts(1, 6)

    def run(F, eng):
        bad = F.FaultyReplica(eng(), raise_on_step=(3, None))
        return _fleet_tokens(F.Fleet(
            [bad, eng()], policy="round_robin",
            health=F.HealthConfig(dead_consecutive=2, cooldown_steps=50),
            retry=F.RetryPolicy(max_attempts=6, jitter=0.0),
            step_workers=1), prompts, 7)

    want, js = run(jfleet, lambda: jserving.Engine(jm, params, slots=2,
                                                   buf_len=24))
    got, s = run(package("port").fleet,
                 lambda: serving.Engine(tm, slots=2, buf_len=24))
    assert got == want
    assert s["failovers"] == js["failovers"] >= 1
    assert s["failed"] == 0 and s["dead"] == 1
    single = serving.Engine(tm, slots=2, buf_len=24)
    srids = [single.submit(p, max_new_tokens=7) for p in prompts]
    while single.live() or single.queue_depth():
        single.step()
    assert got == [single.result(r) for r in srids]


def test_failover_paged_replicas_greedy_and_sampled(gpt):
    """Paged replicas through a failover: greedy requests give the JAX
    fleet's tokens; seeded sampled ones (the port's own stream) give the
    port's single ``PagedEngine``'s."""
    jm, params, tm = gpt
    prompts = _prompts(4, 6)
    kws = [dict(temperature=0.0) if i % 2 == 0 else dict(seed=100 + i)
           for i in range(len(prompts))]

    def paged():
        return serving.PagedEngine(tm, slots=2, buf_len=24, block_size=8,
                                   window=2, temperature=0.8, top_k=8,
                                   rng=7)

    single = paged()
    srids = [single.submit(p, max_new_tokens=7, **kw)
             for p, kw in zip(prompts, kws)]
    while single.live() or single.queue_depth():
        single.step()
    expected = [single.result(r) for r in srids]
    got, s = _fleet_tokens(Fleet(
        [FaultyReplica(paged(), raise_on_step=(3, None)), paged()],
        policy="round_robin",
        health=HealthConfig(dead_consecutive=2, cooldown_steps=50),
        retry=RetryPolicy(max_attempts=6, jitter=0.0), step_workers=1),
        prompts, 7, kws)
    assert s["failovers"] >= 1 and s["failed"] == 0
    assert got == expected
    # the greedy half against the JAX package's paged fleet
    greedy = prompts[0::2]

    def jpaged():
        return jserving.PagedEngine(jm, params, slots=2, buf_len=24,
                                    block_size=8, window=2)

    want, _ = _fleet_tokens(jfleet.Fleet(
        [jfleet.FaultyReplica(jpaged(), raise_on_step=(3, None)),
         jpaged()], policy="round_robin",
        health=jfleet.HealthConfig(dead_consecutive=2, cooldown_steps=50),
        retry=jfleet.RetryPolicy(max_attempts=6, jitter=0.0),
        step_workers=1), greedy, 7)
    assert got[0::2] == want


def test_step_workers_one_and_two_give_identical_results(gpt):
    """Results and the ordered post-processing do not depend on the
    thread count, with engines; a traced run keeps every window-decode
    span under its own replica's step span."""
    _, _, tm = gpt
    prompts = _prompts(7, 6)
    outs = []
    for workers in (1, 2):
        rec = obs.SpanRecorder()
        prev = obs.set_recorder(rec)
        try:
            with Fleet([serving.Engine(tm, slots=2, buf_len=24, window=2)
                        for _ in range(2)], policy="least_loaded",
                       step_workers=workers) as fl:
                toks, s = _fleet_tokens(fl, prompts, 5)
                s.pop("replica_stats")
                outs.append((toks, {k: s[k] for k in (
                    "submitted", "finished", "tokens_generated", "failed",
                    "failovers", "states")}))
                fevs = rec.trace(fl.trace_id)
                steps = {e["span_id"]: e for e in fevs
                         if e["name"] == "fleet_replica_step"}
                decodes = [e for e in fevs
                           if e["name"] == "engine_window_decode"]
                assert steps and decodes
                for e in decodes:
                    assert e["parent_id"] in steps
                    assert e["tid"] == steps[e["parent_id"]]["tid"]
        finally:
            obs.set_recorder(prev)
    assert outs[0] == outs[1]


def test_prefix_affinity_routes_to_the_owner(gpt):
    jm, params, tm = gpt
    rng = np.random.RandomState(3)
    prefix = [int(t) for t in rng.randint(0, 64, 6)]
    suffix = [int(t) for t in rng.randint(0, 64, 4)]
    other = [int(t) for t in rng.randint(0, 64, 5)]
    fl = Fleet([serving.Engine(tm, slots=2, buf_len=24, prefix_pool=1)
                for _ in range(2)], policy="prefix_affinity",
               step_workers=1)
    assert fl.register_prefix(prefix, replica=1) == 1
    a = fl.submit(prefix + suffix, max_new_tokens=5)
    b = fl.submit(other, max_new_tokens=5)
    drive(fl)
    assert fl.replicas[1].prefix_hits == 1 and fl.replicas[0].prefix_hits == 0
    jfl = jfleet.Fleet([jserving.Engine(jm, params, slots=2, buf_len=24,
                                        prefix_pool=1) for _ in range(2)],
                       policy="prefix_affinity", step_workers=1)
    jfl.register_prefix(prefix, replica=1)
    ja = jfl.submit(prefix + suffix, max_new_tokens=5)
    jb = jfl.submit(other, max_new_tokens=5)
    drive(jfl)
    assert fl.result(a) == [int(t) for t in jfl.result(ja)]
    assert fl.result(b) == [int(t) for t in jfl.result(jb)]


def test_warmup_on_the_cpu_captures_nothing(gpt):
    """``Fleet.warmup`` warms every replica (a ``FaultyReplica`` delegates
    without advancing its windows); on the CPU no graph is captured and
    nothing is left to capture, so every replica may use the pool."""
    _, _, tm = gpt
    bad = FaultyReplica(serving.Engine(tm, slots=2, buf_len=24),
                        raise_on_step=(1, None))
    fl = Fleet([bad, serving.Engine(tm, slots=2, buf_len=24,
                                    prefix_pool=1)], step_workers=2)
    assert fl.warmup() is fl
    assert bad.steps == 0 and bad.faults_fired == 0
    for rep in fl.replicas:
        assert rep.captures == {} and rep.uncaptured() == []
    Fleet([StubReplica(), StubReplica()]).warmup()
