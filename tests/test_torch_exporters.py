"""The port's record exporters and validators
(``apex_tpu_torch.observability.exporters``) and flight recorder
(``flightrec``) against the JAX package's, on the CPU.

``exporters`` is the JAX package's module copied whole, so every
``validate_*`` must give the JAX package's error list on the same record:
the records both fleets emit (``kind: fleet``, ``kind: trace``, ``kind:
recovery``), the JAX tests' mutation sets (tests/test_fleet.py's fleet
record and SLO fields), and a differential sweep that drops each key of
those records or swaps its value for a wrong type, through every
validator.  The schema constants and the ``RECOVERY_*`` tuples (kept in
two copies in each package, ``exporters`` and ``fleet.recovery``) are
pinned equal; the Prometheus exposition of one fleet's registry and a
ring's dump are byte-equal.
"""

import json

import pytest

from apex_tpu.observability import exporters as jexporters
from apex_tpu.observability import flightrec as jflightrec

from apex_tpu_torch.fleet import recovery
from apex_tpu_torch.observability import exporters, flightrec

from torch_fleet_util import (StubReplica, TickClock, canon, drive,
                              package, twin)

VALIDATORS = sorted(n for n in dir(jexporters)
                    if n.startswith("validate_") and not n.endswith("jsonl")
                    and n != "validate_prometheus_text")


def test_the_module_is_the_jax_packages():
    """The same public names, and the same value for every constant."""
    pub = {n for n in dir(jexporters) if not n.startswith("__")}
    assert {n for n in dir(exporters) if not n.startswith("__")} >= pub
    for n in sorted(pub - {"_host_info_cache"}):    # a per-process cache
        v = getattr(jexporters, n)
        if isinstance(v, (int, float, str, tuple, frozenset, dict)):
            assert getattr(exporters, n) == v, n
    assert exporters.__all__ == jexporters.__all__
    assert exporters.SCHEMA_VERSION == jexporters.SCHEMA_VERSION


def test_recovery_tuples_pinned_equal():
    for name in ("RECOVERY_ROLES", "RECOVERY_ACTION_KINDS",
                 "RECOVERY_CAUSES"):
        assert getattr(recovery, name) == getattr(exporters, name) \
            == getattr(jexporters, name)


def _records(pk):
    """A fleet record, a traced request's record and the controller's
    recovery record, from one stub run with a failover (the host and the
    fleet's trace id made equal across the packages)."""
    F, E = pk.fleet, pk.exporters
    clk = TickClock()
    ring = pk.obs.EventRing(64, clock=clk)
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
        ctrl = F.SloController(fl, F.AutoscaleConfig(backlog_factor=1.0,
                                                     cooldown_ticks=1),
                               clock=clk)
        rids = [fl.submit([1, 2, 3], max_new_tokens=6, tenant="a",
                          deadline=50.0),
                fl.submit([4, 5], max_new_tokens=3, tenant="b")]
        drive(fl, clock=clk)
        ctrl.tick()
        out = {"fleet": E.JsonlExporter.enrich(fl.record()),
               "trace": E.JsonlExporter.enrich(fl.trace_record(rids[0])),
               "recovery": E.JsonlExporter.enrich(ctrl.record())}
    finally:
        pk.obs.set_recorder(prev)
    for r in out.values():
        r["host"] = {"hostname": "h", "pid": 1, "platform": "linux",
                     "python": "3.12"}
    return out


@pytest.fixture(scope="module")
def records():
    recs = {name: _records(package(name)) for name in ("jax", "port")}
    for kind in ("fleet", "recovery"):
        assert canon(recs["port"][kind]) == canon(recs["jax"][kind]), kind
    return recs["port"]


@pytest.mark.parametrize("kind", ["fleet", "trace", "recovery"])
def test_emitted_records_validate_in_both_packages(records, kind):
    rec = records[kind]
    for mod in (exporters, jexporters):
        assert getattr(mod, f"validate_{kind}_record")(rec) == []
        assert mod.validate_telemetry_record(rec) == []


def _same_errors(rec):
    for name in VALIDATORS:
        try:
            want = ("ok", getattr(jexporters, name)(rec))
        except Exception as e:          # noqa: BLE001 — compared below
            want = ("raised", type(e).__name__)
        try:
            got = ("ok", getattr(exporters, name)(rec))
        except Exception as e:          # noqa: BLE001
            got = ("raised", type(e).__name__)
        assert got == want, (name, rec)


def test_fleet_record_mutations_give_the_jax_packages_errors(records):
    """tests/test_fleet.py's two mutation sets of a fleet record."""
    rec = records["fleet"]
    cases = [{**rec, "kind": "wat"}, {**rec, "policy": ""},
             {**rec, "failovers": -1}, {**rec, "healthy": 3},
             {**rec, "finished": 9},
             {k: v for k, v in rec.items() if k != "shed"},
             {k: v for k, v in rec.items() if k != "trace_id"},
             {k: v for k, v in rec.items() if k != "trace_id"}
             | {"schema_version": 1},
             {**rec, "schema_version": None}, {**rec, "schema_version": "2"},
             {**rec, "goodput_tokens_per_s": -1},
             {**rec, "slo_attainment": 1.5},
             {**rec, "tokens_within_slo": -2},
             {**rec, "tokens_within_slo": rec["tokens"] + 1},
             {**rec, "deadline_exceeded": -1},
             {**rec, "deadline_last_sweep": {"count": 0, "rids": [1, 2],
                                             "fleet_step": None}},
             {**rec, "deadline_last_sweep": "yesterday"},
             {**rec, "slo_attainment": None},
             {k: v for k, v in rec.items()
              if k not in ("goodput_tokens_per_s", "slo_attainment",
                           "tokens_within_slo", "deadline_exceeded",
                           "deadline_last_sweep")},
             {k: v for k, v in rec.items()
              if k not in ("tenants", "tenants_dropped")},
             {k: v for k, v in rec.items()
              if k not in ("tenants", "tenants_dropped")}
             | {"schema_version": 10}]
    flagged = 0
    for bad in cases:
        errs = exporters.validate_fleet_record(bad)
        assert errs == jexporters.validate_fleet_record(bad), bad
        flagged += bool(errs)
        _same_errors(bad)
    assert flagged >= 16


_WRONG = (None, -1, "", "x", 1.5, [], {}, True, float("nan"))


@pytest.mark.parametrize("kind", ["fleet", "trace", "recovery"])
def test_differential_sweep_through_every_validator(records, kind):
    """Each key of an emitted record dropped, or its value swapped for a
    wrong type, through every ``validate_*``: the port's errors are the
    JAX package's, record for record."""
    rec = records[kind]
    _same_errors(rec)
    for key in sorted(rec):
        _same_errors({k: v for k, v in rec.items() if k != key})
        for wrong in _WRONG:
            _same_errors({**rec, key: wrong})
    for odd in (None, [], {}, {"kind": kind}, "fleet"):
        _same_errors(odd)


def test_jsonl_validators_and_envelope():
    lines = [json.dumps(exporters.JsonlExporter.enrich(
        {"metric": "m", "value": 1.0, "unit": "tokens/sec",
         "backend": "cpu", "ndev": 1, "arch": "cpu"})), "{not json", ""]
    assert exporters.validate_bench_jsonl(lines) == \
        jexporters.validate_bench_jsonl(lines)
    assert exporters.validate_telemetry_jsonl(lines) == \
        jexporters.validate_telemetry_jsonl(lines)
    env = exporters.JsonlExporter.enrich({"kind": "fleet"}, stale=True)
    assert env["stale"] is True and "host" in env
    assert set(env["host"]) == set(jexporters.host_info())


def _prometheus(pk):
    clk = TickClock()
    F = pk.fleet
    fl = F.Fleet([StubReplica(), StubReplica()], step_workers=1, clock=clk,
                 ring=pk.obs.EventRing(16, clock=clk))
    for i in range(5):
        fl.submit([1] * (i + 1), max_new_tokens=3, tenant=f"t{i % 2}",
                  deadline=20.0)
    drive(fl, clock=clk)
    text = pk.exporters.prometheus_text(fl.metrics)
    assert pk.exporters.validate_prometheus_text(text) == []
    return {"text": text,
            "parsed": pk.exporters.parse_prometheus_text(text)}


def test_prometheus_exposition_equal():
    got = twin(_prometheus)
    assert "fleet_finished_total 5" in got["text"]


def test_flight_ring_dump_equal(tmp_path):
    out = []
    for mod in (flightrec, jflightrec):
        clk = TickClock()
        ring = mod.EventRing(capacity=3, clock=clk)
        for i in range(5):
            clk.t += 0.5
            ring.append("failover", replica=i, tenants=["a"], reason=i * 2)
        assert ring.stats() == {"capacity": 3, "total": 5, "retained": 3,
                                "dropped": 2}
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        ring.dump(path)
        with open(path) as f:
            out.append(f.read())
        assert [e["kind"] for e in ring.snapshot(tenant="a")] == \
            ["failover"] * 3
    assert out[0] == out[1]
    assert json.loads(out[0].splitlines()[0])["dropped"] == 2
    # the process ring: get/set/resolve swap like the JAX package's
    fresh = flightrec.EventRing(4)
    prev = flightrec.set_ring(fresh)
    try:
        assert flightrec.get_ring() is fresh
        assert flightrec.resolve(None) is fresh
        flightrec.record("shed", queue_depth=1)
        assert fresh.snapshot()[0]["kind"] == "shed"
    finally:
        flightrec.set_ring(prev)
    with pytest.raises(ValueError):
        flightrec.EventRing(0)
