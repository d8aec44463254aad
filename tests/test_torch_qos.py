"""The port's QoS plane (``apex_tpu_torch.fleet.qos``: priority classes,
weighted-fair queuing, decode preemption) against the JAX package's, on
the CPU; tests/test_qos.py is the parity spec.

The scheduling machinery (stride order, per-class quotas, preemption and
its victim choice, the controller's per-class actuation, the schema-v14
record) runs a JAX fleet and a port fleet over identical stub replicas
under one injected clock (``tests/torch_fleet_util.py``), and every
observable is equal.  The engine pins run the port's ``PagedEngine`` at
the JAX serving tests' model in fp32: a preempted request, and one
preempted and then failed over, end with the JAX fleet's greedy tokens
(a sampled one with the port's single engine's).
"""

import json

import pytest

from apex_tpu import fleet as jfleet
from apex_tpu import serving as jserving

from apex_tpu_torch import serving
from apex_tpu_torch.fleet import FaultyReplica, Fleet, HealthConfig, \
    RetryPolicy
from apex_tpu_torch.fleet.qos import (DEFAULT_CLASS, QosClass, QosPolicy,
                                      WfqQueue)
from apex_tpu_torch.observability import exporters
from apex_tpu_torch.observability.flightrec import (EventRing,
                                                    event_matches_tenant)

import torch_serving_util as su
from torch_fleet_util import (StubReplica, TickClock, drive, observe,
                              package, twin)


def _two_class(pk, **kw):
    Q = pk.qos
    return Q.QosPolicy(
        [Q.QosClass("interactive", weight=8, preemptible=False),
         Q.QosClass("batch", weight=1, **kw)],
        tenant_class={"alice": "interactive", "bob": "batch"})


class _Tagged:
    def __init__(self, rid, qos_class):
        self.rid = rid
        self.qos_class = qos_class


def _order(pk, pol, items):
    q = pk.qos.WfqQueue(pol)
    for rid, cls in items:
        q.append(_Tagged(rid, cls))
    out = []
    while q:
        head = q[0]
        q.remove(head)
        out.append((head.rid, head.qos_class))
    return out


def test_policy_validation_and_resolution():
    for bad in (dict(name="", weight=1), dict(name="x", weight=0),
                dict(name="x", weight=True), dict(name="x", deadline_s=0.0),
                dict(name="x", queue_share=0.0)):
        with pytest.raises(ValueError):
            QosClass(**bad)
    with pytest.raises(ValueError):
        QosPolicy([])
    with pytest.raises(ValueError):
        QosPolicy([QosClass("a"), QosClass("a")])
    with pytest.raises(ValueError):
        QosPolicy([QosClass("a")], tenant_class={"t": "nope"})
    with pytest.raises(ValueError):
        QosPolicy([QosClass("a")], default_class="nope")
    pols = [_two_class(package(n)) for n in ("jax", "port")]
    for args in (dict(tenant="alice"), dict(tenant="alice", priority="batch"),
                 dict(tenant="nobody"), {}, dict(priority="made-up")):
        assert pols[1].resolve(**args) == pols[0].resolve(**args)
    for c in ("interactive", "batch", "made-up"):
        assert pols[1].rank(c) == pols[0].rank(c)
        assert pols[1].preemptible(c) == pols[0].preemptible(c)
    capped = QosPolicy([QosClass("a"), QosClass("b", queue_share=0.01)])
    assert capped.cap("b", 10) == 1 and capped.cap("a", 10) == 10
    assert list(QosPolicy.single().classes) == [DEFAULT_CLASS]


def test_wfq_single_class_is_exact_fifo():
    q = WfqQueue()
    reqs = [_Tagged(i, None) for i in range(6)]
    for r in reqs:
        q.append(r)
    assert list(q) == reqs
    q.remove(reqs[2])
    q[:0] = [reqs[2]]
    assert q[0] is reqs[2] and len(q) == 6
    with pytest.raises(TypeError):
        q[0] = reqs[1]


@pytest.mark.parametrize("mix", ["batch_flood", "interactive_flood",
                                 "interleaved"])
def test_wfq_order_equals_the_jax_queues(mix):
    items = {"batch_flood": [(i, "batch") for i in range(20)]
             + [(100 + i, "interactive") for i in range(3)],
             "interactive_flood": [(i, "interactive") for i in range(20)]
             + [(100 + i, "batch") for i in range(3)],
             "interleaved": [(i, ("batch", "interactive")[i % 3 == 0])
                             for i in range(17)]}[mix]
    got = twin(lambda pk: _order(pk, _two_class(pk), items))
    pos = [i for i, (_, c) in enumerate(got) if c == "interactive"]
    if mix == "batch_flood":
        assert max(pos) <= 4


def test_wfq_waking_class_inherits_live_pass():
    def run(pk):
        q = pk.qos.WfqQueue(_two_class(pk))
        for i in range(6):
            q.append(_Tagged(i, "batch"))
        for _ in range(3):
            q.remove(q[0])
        for i in range(4):
            q.append(_Tagged(100 + i, "interactive"))
        return [(r.rid, r.qos_class) for r in q]

    order = twin(run)
    assert order[0][1] == "interactive" and order[1][1] == "batch"


# -- fleet scenarios over stubs, twinned -------------------------------------

def _fleet(pk, clk, slots=1, cap=0, n=1, **kw):
    ring = pk.obs.EventRing(capacity=64, clock=clk)
    max_queue = kw.pop("max_queue", 8)
    qos = kw.pop("qos") if "qos" in kw else _two_class(pk, **kw)
    fl = pk.fleet.Fleet([StubReplica(slots=slots) for _ in range(n)],
                        max_queue=max_queue, replica_queue_cap=cap,
                        step_workers=1, ring=ring, clock=clk, qos=qos)
    return fl, ring


def _quota(pk):
    clk = TickClock()
    fl, ring = _fleet(pk, clk, queue_share=0.25)
    rids = [fl.submit([1], max_new_tokens=30, tenant="bob")]
    fl.step()
    rids += [fl.submit([1, 2], max_new_tokens=1, tenant="bob"),
             fl.submit([1, 2, 3], max_new_tokens=1, tenant="bob")]
    with pytest.raises(pk.fleet.FleetOverloaded) as ei:
        fl.submit([1, 2, 3, 4], max_new_tokens=1, tenant="bob")
    assert ei.value.qos_class == "batch"
    rids.append(fl.submit([5, 6], max_new_tokens=1, tenant="alice"))
    s = fl.stats()
    assert s["classes"]["batch"]["shed"] == 1
    assert s["classes"]["interactive"]["shed"] == 0
    drive(fl, clock=clk)
    return observe(fl, rids, ring)


def _preempt(pk):
    clk = TickClock()
    fl, ring = _fleet(pk, clk)
    vic = fl.submit([1, 2], max_new_tokens=4, tenant="bob")
    fl.step()
    hi = fl.submit([3, 4, 5], max_new_tokens=2, tenant="alice")
    fl.step()
    (ev,) = ring.snapshot("preemption")
    assert ev["evicted_rid"] == vic and ev["admitted_rid"] == hi
    assert ev["tenants"] == ["alice", "bob"]
    drive(fl, clock=clk)
    s = fl.stats()
    assert s["preemptions"] == 1 and s["retries"] == 0
    assert fl.result(vic) == StubReplica.expected([1, 2], 4)
    return observe(fl, [vic, hi], ring)


def _victim_choice(pk):
    clk = TickClock()
    fl, ring = _fleet(pk, clk, slots=2)
    rids = [fl.submit([1, 2], max_new_tokens=6, tenant="bob"),
            fl.submit([1, 2, 3], max_new_tokens=6, tenant="bob")]
    fl.step()
    rids.append(fl.submit([9], max_new_tokens=1, tenant="alice"))
    fl.step()
    (ev,) = ring.snapshot("preemption")
    assert ev["evicted_rid"] == rids[1]       # the youngest
    drive(fl, clock=clk)
    return observe(fl, rids, ring)


def _preempt_over_queue(pk):
    clk = TickClock()
    fl, ring = _fleet(pk, clk, cap=4)
    vic = fl.submit([1, 2], max_new_tokens=6, tenant="bob")
    fl.step()
    hi = fl.submit([3, 4], max_new_tokens=2, tenant="alice")
    fl.step()
    assert len(ring.snapshot("preemption")) == 1
    drive(fl, clock=clk)
    fl2, ring2 = _fleet(pk, clk, cap=4)
    r2 = [fl2.submit([1], max_new_tokens=4, tenant="bob")]
    fl2.step()
    r2.append(fl2.submit([2], max_new_tokens=1, tenant="bob"))
    fl2.step()
    assert fl2.stats()["preemptions"] == 0
    drive(fl2, clock=clk)
    return {"a": observe(fl, [vic, hi], ring), "b": observe(fl2, r2, ring2)}


def _single_class(pk):
    clk = TickClock()
    fl, ring = _fleet(pk, clk, qos=None)
    rids = [fl.submit([1, 2], max_new_tokens=4)]
    fl.step()
    rids.append(fl.submit([3], max_new_tokens=1, priority=0))
    drive(fl, clock=clk)
    s = fl.stats()
    assert s["preemptions"] == 0 and list(s["classes"]) == ["default"]
    return observe(fl, rids, ring)


def _controller(pk):
    clk = TickClock()
    pol = _two_class(pk, queue_share=0.5)
    fl, ring = _fleet(pk, clk, max_queue=16, qos=pol)
    ctrl = pk.fleet.SloController(
        fl, pk.fleet.AutoscaleConfig(backlog_factor=1.0, min_queue=2,
                                     relax_after_ticks=1, cooldown_ticks=1),
        clock=clk)
    base_cap = pol.cap("batch", fl.max_queue)
    rids = [fl.submit([1], max_new_tokens=40, tenant="bob")]
    fl.step()
    rids += [fl.submit([1, k], max_new_tokens=1, tenant="bob")
             for k in range(7)]
    acts = []
    for _ in range(6):
        fl.step()
        clk.t += 1.0
        acts += ctrl.tick()
    tight = [a for a in acts if a["kind"] == "class_admission_tighten"]
    assert tight and tight[0]["qos_class"] == "batch"
    assert pol.cap("interactive", fl.max_queue) == fl.max_queue
    drive(fl, clock=clk)
    for _ in range(30):
        fl.step()
        clk.t += 1.0
        acts += ctrl.tick()
        if pol.cap("batch", fl.max_queue) == base_cap:
            break
    assert pol.cap("batch", fl.max_queue) == base_cap
    rec = pk.exporters.JsonlExporter.enrich(ctrl.record())
    assert pk.exporters.validate_recovery_record(rec) == []
    rec.pop("host")
    return {**observe(fl, rids, ring), "actions": acts, "ctrl": rec}


def _v14_record(pk):
    clk = TickClock()
    fl, ring = _fleet(pk, clk, slots=2)
    rids = [fl.submit([1, 2], max_new_tokens=3, tenant="bob"),
            fl.submit([2, 3], max_new_tokens=2, tenant="alice")]
    drive(fl, clock=clk)
    return observe(fl, rids, ring)


QOS_SCENARIOS = {f.__name__[1:]: f for f in (
    _quota, _preempt, _victim_choice, _preempt_over_queue, _single_class,
    _controller, _v14_record)}


@pytest.mark.parametrize("name", sorted(QOS_SCENARIOS))
def test_qos_fleet_twin(name):
    twin(QOS_SCENARIOS[name])


def test_event_matches_tenant_both_directions():
    assert event_matches_tenant({"tenant": "acme"}, "acme")
    assert not event_matches_tenant({"tenant": "acme"}, "zeta")
    assert event_matches_tenant({"tenants": ["acme", "zeta"]}, "zeta")
    assert not event_matches_tenant({"tenants": None}, "acme")
    ring = EventRing(capacity=16)
    ring.append("shed", tenant="acme")
    ring.append("failover", tenants=["acme", "zeta"], reclaimed=2)
    ring.append("preemption", tenants=["zeta"])
    assert [e["kind"] for e in ring.snapshot(tenant="acme")] == \
        ["shed", "failover"]
    assert [e["kind"] for e in ring.snapshot(tenant="zeta")] == \
        ["failover", "preemption"]


def _mutations(rec):
    """The JAX tests' schema-v14 mutation set of a fleet record."""
    def mutated(**kw):
        r = json.loads(json.dumps(rec))
        for k, v in kw.items():
            if k == "preemptions":
                r[k] = v
            else:
                r["classes"]["batch"][k] = v
        return r

    out = [{k: v for k, v in rec.items() if k != m}
           for m in ("classes", "preemptions")]
    v13 = {k: v for k, v in rec.items()
           if k not in ("classes", "preemptions")}
    out.append(dict(v13, schema_version=13))
    out += [mutated(preemptions=-1), mutated(preempted=-2),
            mutated(preempted=5, preemptions=1),
            mutated(slo_attainment=1.5), mutated(weight=0)]
    return out


def test_v14_validators_give_the_jax_packages_errors():
    from apex_tpu.observability import exporters as jexporters
    from apex_tpu.fleet import slo as jslo
    from apex_tpu_torch.fleet import slo
    assert exporters.SCHEMA_VERSION == jexporters.SCHEMA_VERSION >= 14
    assert exporters.CLASS_COUNTS == jexporters.CLASS_COUNTS == tuple(
        k for k in slo._new_class_bucket() if k not in ("t_first", "t_last"))
    assert list(slo._new_class_bucket()) == list(jslo._new_class_bucket())
    for name in ("jax", "port"):
        rec = package(name).exporters.JsonlExporter.enrich(
            twin(_v14_record)["record"])
        assert exporters.validate_fleet_record(rec) == []
        for bad in _mutations(rec):
            assert exporters.validate_fleet_record(bad) == \
                jexporters.validate_fleet_record(bad)
        assert any(exporters.validate_fleet_record(b)
                   for b in _mutations(rec))
    base = {"unit": "tokens/sec", "backend": "cpu", "ndev": 1,
            "arch": "cpu"}
    cls = exporters.JsonlExporter.enrich(dict(
        base, metric="gpt_tiny_fleet2_qos_class_interactive_goodput",
        value=100.0, qos_class="interactive", slo_attainment=1.0))
    parity = exporters.JsonlExporter.enrich(dict(
        base, metric="gpt_tiny_fleet_qos_preemption_parity", unit="ratio",
        value=1.0, matched_tokens=16, expected_tokens=16, preemptions=1,
        steady_state_retraces=0))
    cases = [cls, dict(cls, qos_class=""), dict(cls, slo_attainment=1.5),
             parity, dict(parity, preemptions=0), dict(parity, value=0.5)]
    cases += [{k: v for k, v in cls.items() if k != m}
              for m in ("qos_class", "slo_attainment")]
    cases += [{k: v for k, v in parity.items() if k != m}
              for m in ("matched_tokens", "expected_tokens")]
    for c in cases:
        assert exporters.validate_bench_record(c) == \
            jexporters.validate_bench_record(c)
        assert exporters.validate_telemetry_record(c) == \
            jexporters.validate_telemetry_record(c)


# -- the engine pins, fp32 ----------------------------------------------------

@pytest.fixture(scope="module")
def gpt6():
    return su.gpt(6)


def _paged(tm, **kw):
    return serving.PagedEngine(tm, slots=2, buf_len=24, block_size=8,
                               window=2, **kw)


def test_preemption_exactness_paged(gpt6):
    """A batch request evicted mid-decode from a paged replica and
    readmitted ends with its undisturbed tokens: the greedy ones equal
    the JAX fleet's, the seeded sampled one the port's single engine's."""
    jm, params, tm = gpt6
    prompts = su.prompts(4, (5, 7, 4))
    new = [10, 10, 4]
    kws = [dict(temperature=0.0), dict(seed=107), dict(temperature=0.0)]
    single = _paged(tm, temperature=0.8, top_k=8, rng=7)
    srids = [single.submit(p, max_new_tokens=n, **kw)
             for p, n, kw in zip(prompts, new, kws)]
    while single.live() or single.queue_depth():
        single.step()
    expected = [single.result(r) for r in srids]

    def run(F, eng, kws):
        pk = package("jax" if F is jfleet else "port")
        fl = F.Fleet([eng()], max_queue=16, replica_queue_cap=0,
                     retry=F.RetryPolicy(max_attempts=8, jitter=0.0),
                     step_workers=1, ring=pk.obs.EventRing(capacity=64),
                     qos=_two_class(pk))
        rids = [fl.submit(prompts[i], max_new_tokens=new[i], tenant="bob",
                          **kws[i]) for i in (0, 1)]
        fl.step()
        rids.append(fl.submit(prompts[2], max_new_tokens=new[2],
                              tenant="alice", **kws[2]))
        drive(fl)
        return [[int(t) for t in fl.result(r)] for r in rids], fl

    got, fl = run(package("port").fleet,
                  lambda: _paged(tm, temperature=0.8, top_k=8, rng=7), kws)
    assert fl.stats()["preemptions"] >= 1 and fl.stats()["failed"] == 0
    assert got == expected
    gport, _ = run(package("port").fleet, lambda: _paged(tm), [{}] * 3)
    gjax, jfl = run(jfleet, lambda: jserving.PagedEngine(
        jm, params, slots=2, buf_len=24, block_size=8, window=2), [{}] * 3)
    assert gport == gjax and jfl.stats()["preemptions"] >= 1
    assert gport[0] == got[0] and gport[2] == got[2]


def test_preemption_composed_with_failover(gpt6):
    """A replica dies while a preempted-then-readmitted request is back
    in flight: every result is the JAX fleet's, exactly once, and the
    ring's preemption and failover events name the tenants."""
    jm, params, tm = gpt6
    prompts = su.prompts(6, (3, 7, 5, 4, 6))
    new = [3, 10, 10, 10, 4]

    def run(name, eng):
        pk = package(name)
        F = pk.fleet
        fl = F.Fleet([F.FaultyReplica(eng(), raise_on_step=(6, None)),
                      eng()], policy="round_robin", max_queue=16,
                     replica_queue_cap=0,
                     health=F.HealthConfig(dead_consecutive=2,
                                           cooldown_steps=50),
                     retry=F.RetryPolicy(max_attempts=8, jitter=0.0),
                     step_workers=1, ring=pk.obs.EventRing(capacity=128),
                     qos=_two_class(pk))
        rids = [fl.submit(p, max_new_tokens=n, tenant="bob")
                for p, n in zip(prompts[:4], new[:4])]
        fl.step()
        rids.append(fl.submit(prompts[4], max_new_tokens=new[4],
                              tenant="alice"))
        drive(fl)
        s = fl.stats()
        kinds = [e["kind"] for e in fl.ring.snapshot()]
        return ([[int(t) for t in fl.result(r)] for r in rids],
                [fl.status(r) for r in rids],
                {k: s[k] for k in ("preemptions", "failovers", "failed",
                                   "finished")}, kinds,
                fl.ring.snapshot("preemption")[0]["tenants"])

    got = run("port", lambda: _paged(tm))
    want = run("jax", lambda: jserving.PagedEngine(
        jm, params, slots=2, buf_len=24, block_size=8, window=2))
    assert got[0] == want[0]
    assert got[1] == ["finished"] * 5
    assert got[2] == want[2]
    assert got[2]["preemptions"] >= 1 and got[2]["failovers"] >= 1
    assert got[2]["failed"] == 0
    assert got[4] == ["alice", "bob"]


def test_preemption_composed_with_failover_equals_the_single_engine(gpt6):
    _, _, tm = gpt6
    prompts = su.prompts(6, (3, 7, 5, 4, 6))
    new = [3, 10, 10, 10, 4]
    single = _paged(tm)
    srids = [single.submit(p, max_new_tokens=n)
             for p, n in zip(prompts, new)]
    while single.live() or single.queue_depth():
        single.step()
    fl = Fleet([FaultyReplica(_paged(tm), raise_on_step=(6, None)),
                _paged(tm)], policy="round_robin", max_queue=16,
               replica_queue_cap=0,
               health=HealthConfig(dead_consecutive=2, cooldown_steps=50),
               retry=RetryPolicy(max_attempts=8, jitter=0.0),
               step_workers=2, ring=EventRing(capacity=128),
               qos=_two_class(package("port")))
    rids = [fl.submit(p, max_new_tokens=n, tenant="bob")
            for p, n in zip(prompts[:4], new[:4])]
    fl.step()
    rids.append(fl.submit(prompts[4], max_new_tokens=new[4],
                          tenant="alice"))
    drive(fl)
    fl.close()
    assert [fl.result(r) for r in rids] == \
        [single.result(r) for r in srids]
