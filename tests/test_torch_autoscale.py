"""The serving SLO-feedback controller (``apex_tpu_torch.fleet.autoscale``),
the shared recovery bookkeeping (``fleet.recovery``: ``RecoveryLog``,
``PreemptionGuard``, ``reshard_flat_state``) and the fleet's MTTR, against
the JAX package's on the CPU; tests/test_autoscale.py and the
non-trainer half of tests/test_recovery.py are the parity spec.

Every controller scenario runs a JAX fleet and a port fleet of stub
replicas (``tests/torch_fleet_util.py``) under one injected tick clock:
the controller's action list (kinds, order, detail), its ``kind:
recovery`` record and the fleet's observables are equal.  The elastic
trainer is not ported (ROADMAP.md item 8b) and raises.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from apex_tpu.fleet import recovery as jrecovery
from apex_tpu.observability import exporters as jexporters

from apex_tpu_torch import observability as obs
from apex_tpu_torch.fleet import (ElasticConfig, ElasticTrainer,
                                  PreemptionGuard, RecoveryLog,
                                  reshard_flat_state)
from apex_tpu_torch.fleet.recovery import (RECOVERY_ACTION_KINDS,
                                           RECOVERY_CAUSES, RECOVERY_ROLES)
from apex_tpu_torch.observability import exporters
from apex_tpu_torch.observability.exporters import (
    JsonlExporter, validate_recovery_record)

from torch_fleet_util import (StubReplica, TickClock, WindowStub, observe,
                              twin)


def test_action_kinds_pinned_across_packages_and_exporters():
    for tup in ("RECOVERY_ACTION_KINDS", "RECOVERY_ROLES",
                "RECOVERY_CAUSES"):
        assert getattr(exporters, tup) == getattr(jexporters, tup) \
            == getattr(jrecovery, tup)
    assert RECOVERY_ACTION_KINDS == exporters.RECOVERY_ACTION_KINDS
    assert RECOVERY_ROLES == exporters.RECOVERY_ROLES
    assert RECOVERY_CAUSES == exporters.RECOVERY_CAUSES


def test_elastic_trainer_is_not_ported_yet():
    for cls in (ElasticTrainer, ElasticConfig):
        with pytest.raises(NotImplementedError, match="item 8b"):
            cls()


def test_recovery_log_rejects_negative_t_s_at_append():
    t = {"v": 100.0}
    log = RecoveryLog("serving", "clockskew", clock=lambda: t["v"])
    t["v"] = 10.0
    with pytest.raises(ValueError, match="[Rr]eset the clock"):
        log.action("undrain")
    t["v"] = 101.0
    assert log.action("undrain")["t_s"] == pytest.approx(1.0)


def _recovery_log(pk):
    clk = TickClock()
    ring = pk.obs.EventRing(64, clock=clk)
    log = pk.recovery.RecoveryLog("serving", "t", clock=clk, ring=ring,
                                  registry=pk.obs.MetricsRegistry())
    assert not log.in_flight
    log.open_episode("spike")
    log.open_episode("spike again")
    assert log.episodes == 1
    log.action("admission_tighten", max_queue_from=8, max_queue_to=4)
    clk.t = 3.0
    log.close_episode(mttr_s=3.0)
    log.action("admission_relax", max_queue_from=4, max_queue_to=8)
    assert log.actions_total == 2 and log.max_actions_in_episode == 1
    assert log.mttr() == {"last": 3.0, "mean": 3.0, "count": 1}
    with pytest.raises(ValueError):
        log.action("reboot_the_universe")
    with pytest.raises(ValueError):
        pk.recovery.RecoveryLog("mystery", "t")
    rec = pk.exporters.JsonlExporter.enrich(log.record())
    assert pk.exporters.validate_recovery_record(rec) == []
    assert pk.exporters.validate_telemetry_record(rec) == []
    rec.pop("host")
    return {"record": rec, "ring": ring.snapshot(),
            "kinds": [e["kind"] for e in ring.snapshot()]}


def test_recovery_log_accounting_twin():
    got = twin(_recovery_log)
    assert got["kinds"] == ["recovery_started", "recovery_action",
                            "recovery_done", "recovery_action"]


def test_recovery_record_mutations_give_the_jax_packages_errors():
    log = RecoveryLog("training", "r")
    log.open_episode("death")
    log.action("world_shrink", world_from=8, world_to=4)
    log.close_episode(mttr_s=0.5)
    good = JsonlExporter.enrich(log.record(world=4, recoveries=1))
    assert validate_recovery_record(good) == []
    cases = [{"role": "parking"}, {"subject": ""}, {"episodes": -1},
             {"actions_total": 0}, {"max_actions_in_episode": 99},
             {"world": 0},
             {"mttr_s": {"last": None, "mean": None, "count": 3}},
             {"mttr_s": {"last": float("nan"), "mean": 0.5, "count": 1}},
             {"actions": [dict(good["actions"][0], kind="reboot")]},
             {"actions": [dict(good["actions"][0], episode=7)]}]
    for patch in cases:
        bad = {**good, **patch}
        errs = validate_recovery_record(bad)
        assert errs, patch
        assert errs == jexporters.validate_recovery_record(bad)


# -- the controller, twinned --------------------------------------------------

def _fleet(pk, clk, n=2, slots=2, max_queue=64, window=8, **kw):
    reps = [WindowStub(slots=slots, window=window) for _ in range(n)]
    ring = pk.obs.EventRing(256, clock=clk)
    fl = pk.fleet.Fleet(reps, policy="least_loaded", max_queue=max_queue,
                        retry=pk.fleet.RetryPolicy(max_attempts=8),
                        step_workers=1, clock=clk, ring=ring, **kw)
    return fl, reps, ring


def _drive(pk, fl, ctrl, clk, *, waves, ticks, deadline=None,
           ctrl_every=2, max_new=4):
    shed, rids, acts = 0, [], []
    for tick in range(ticks):
        for _ in range(waves.get(tick, 0)):
            try:
                rids.append(fl.submit([1, 2, 3], max_new_tokens=max_new,
                                      deadline=deadline))
            except pk.fleet.FleetOverloaded:
                shed += 1
        fl.step()
        clk.t += 1.0
        if ctrl is not None and tick % ctrl_every == ctrl_every - 1:
            acts += ctrl.tick()
    guard = 0
    while fl.live() and guard < 300:
        fl.step()
        clk.t += 1.0
        if ctrl is not None:
            acts += ctrl.tick()
        guard += 1
    assert not fl.live()
    return rids, shed, acts


def _ctrl_record(pk, ctrl):
    rec = pk.exporters.JsonlExporter.enrich(ctrl.record())
    assert pk.exporters.validate_recovery_record(rec) == []
    rec.pop("host")
    return rec


def _run(pk, cfg, waves, ticks, deadline, max_new=4, with_ctrl=True,
         **fkw):
    clk = TickClock()
    fl, reps, ring = _fleet(pk, clk, **fkw)
    ctrl = (pk.fleet.SloController(fl, pk.fleet.AutoscaleConfig(**cfg),
                                   clock=clk) if with_ctrl else None)
    rids, shed, acts = _drive(pk, fl, ctrl, clk, waves=waves, ticks=ticks,
                              deadline=deadline, max_new=max_new)
    out = {**observe(fl, rids, ring), "shed": shed, "actions": acts,
           "windows": [getattr(r, "window", None) for r in reps]}
    if ctrl is not None:
        out["ctrl"] = _ctrl_record(pk, ctrl)
        out["status"] = ctrl.status()
    return out


def _stable(pk):
    out = _run(pk, {}, {t: 1 for t in range(0, 40, 6)}, 48, 30.0)
    assert out["ctrl"]["episodes"] == 0 and out["ctrl"]["actions_total"] == 0
    return out


def _spike(pk):
    cfg = dict(min_queue=4, backlog_factor=2.0, cooldown_ticks=1,
               relax_after_ticks=4, max_actions_per_episode=6)
    out = _run(pk, cfg, {0: 1, 10: 30}, 80, 12.0)
    kinds = [a["kind"] for a in out["ctrl"]["actions"]]
    assert "admission_tighten" in kinds and "admission_relax" in kinds
    assert not out["ctrl"]["in_flight"]
    return out


def _beats_baseline(pk):
    waves = {t: 1 for t in range(0, 90, 6)}
    waves[10] = waves.get(10, 0) + 24
    waves[50] = waves.get(50, 0) + 24
    cfg = dict(min_queue=12, backlog_factor=2.0, cooldown_ticks=1,
               relax_after_ticks=10, max_actions_per_episode=6)
    base = _run(pk, cfg, waves, 110, 24.0, max_new=8, with_ctrl=False)
    ctrl = _run(pk, cfg, waves, 110, 24.0, max_new=8)
    assert ctrl["record"]["slo_attainment"] > \
        base["record"]["slo_attainment"]
    return {"base": base, "ctrl": ctrl}


def _bounded(pk):
    cfg = dict(min_queue=2, backlog_factor=1.0, cooldown_ticks=1,
               relax_after_ticks=50, max_actions_per_episode=3)
    out = _run(pk, cfg, {t: 3 for t in range(0, 60, 2)}, 60, 4.0, n=1,
               slots=1)
    assert out["ctrl"]["episodes"] >= 1
    assert out["ctrl"]["max_actions_in_episode"] <= 3
    return out


def _undrain_first(pk):
    clk = TickClock()
    fl, _, ring = _fleet(pk, clk, n=3)
    fl.drain(2)
    ctrl = pk.fleet.SloController(
        fl, pk.fleet.AutoscaleConfig(backlog_factor=1.0, cooldown_ticks=1),
        clock=clk)
    rids = [fl.submit([1, 2, 3], max_new_tokens=4) for _ in range(20)]
    fl.step()
    clk.t += 1.0
    acts = ctrl.tick()
    assert [a["kind"] for a in acts] == ["undrain"]
    assert fl.max_queue == ctrl.base_max_queue
    return {**observe(fl, rids, ring), "actions": acts}


def _cooldown(pk):
    F = pk.fleet
    clk = TickClock()
    ring = pk.obs.EventRing(256, clock=clk)
    sick = F.FaultyReplica(StubReplica(slots=2), raise_on_step=(0, None),
                           ring=ring)
    fl = F.Fleet([sick, StubReplica(slots=2)], policy="least_loaded",
                 max_queue=64, retry=F.RetryPolicy(max_attempts=8),
                 health=F.HealthConfig(cooldown_steps=32, dead_consecutive=2),
                 step_workers=1, clock=clk, ring=ring)
    ctrl = F.SloController(fl, F.AutoscaleConfig(backlog_factor=1.0,
                                                 cooldown_ticks=1,
                                                 probe_cooldown_steps=1),
                           clock=clk)
    rids = [fl.submit([1, 2, 3], max_new_tokens=4) for _ in range(12)]
    for _ in range(4):
        fl.step()
        clk.t += 1.0
    assert fl.health[0].circuit == "open"
    acts = ctrl.tick()
    assert any(a["kind"] == "cooldown_shorten" for a in acts)
    assert fl.health[0].cooldown_left == 1
    return {**observe(fl, rids, ring), "actions": acts}


def _window(pk):
    clk = TickClock()
    fl, reps, ring = _fleet(pk, clk, max_queue=16)
    ctrl = pk.fleet.SloController(fl, pk.fleet.AutoscaleConfig(
        min_queue=16, backlog_factor=1.0, cooldown_ticks=1,
        relax_after_ticks=2, window_bounds=(2, 8),
        max_actions_per_episode=8), clock=clk)
    rids = [fl.submit([1, 2, 3], max_new_tokens=4) for _ in range(16)]
    fl.step()
    clk.t += 1.0
    acts = ctrl.tick()
    assert [a["kind"] for a in acts] == ["window_shrink"]
    assert reps[0].window == 4
    while fl.live():
        fl.step()
        clk.t += 1.0
    for _ in range(6):
        clk.t += 1.0
        acts += ctrl.tick()
    assert reps[0].window == 8
    return {**observe(fl, rids, ring), "actions": acts,
            "ctrl": _ctrl_record(pk, ctrl)}


def _mttr(pk):
    F = pk.fleet
    clk = TickClock()
    ring = pk.obs.EventRing(256, clock=clk)
    sick = F.FaultyReplica(StubReplica(slots=2), raise_on_step=(2, 3),
                           ring=ring)
    fl = F.Fleet([sick, StubReplica(slots=2)], policy="round_robin",
                 max_queue=16, retry=F.RetryPolicy(max_attempts=8),
                 step_workers=1, clock=clk, ring=ring)
    rids = [fl.submit([1, 2, 3], max_new_tokens=4) for _ in range(4)]
    assert fl.mttr() == {"last": None, "mean": None, "count": 0}
    while fl.live():
        fl.step()
        clk.t += 1.0
    assert fl.mttr() == {"last": 2.0, "mean": 2.0, "count": 1}
    rec = pk.exporters.JsonlExporter.enrich(fl.record())
    assert pk.exporters.validate_fleet_record(rec) == []
    fl.begin_recovery("intentional world shrink")
    assert fl.stats()["recovery_in_flight"] is True
    fl.end_recovery()
    return observe(fl, rids, ring)


CONTROLLER_SCENARIOS = {f.__name__[1:]: f for f in (
    _stable, _spike, _beats_baseline, _bounded, _undrain_first, _cooldown,
    _window, _mttr)}


@pytest.mark.parametrize("name", sorted(CONTROLLER_SCENARIOS))
def test_controller_twin(name):
    twin(CONTROLLER_SCENARIOS[name])


def test_fleet_record_mttr_field_validated():
    good = {"kind": "fleet", "trace_id": "t", "replicas": 1,
            "policy": "p", "healthy": 1, "degraded": 0, "dead": 0,
            "queue_depth": 0, "submitted": 0, "finished": 0,
            "failed": 0, "shed": 0, "retries": 0, "failovers": 0,
            "drains": 0, "tokens": 0, "deadline_exceeded": 0,
            "tenants": {}, "tenants_dropped": 0, "classes": {},
            "preemptions": 0,
            "mttr": {"last": None, "mean": None, "count": 0}}
    for rec in (good, dict(good, mttr={"last": -1.0, "mean": 1.0,
                                       "count": 1}),
                dict(good, mttr="fast")):
        rec = JsonlExporter.enrich(rec)
        assert exporters.validate_fleet_record(rec) == \
            jexporters.validate_fleet_record(rec)
    assert exporters.validate_fleet_record(JsonlExporter.enrich(good)) == []


# -- recovery's host pieces ---------------------------------------------------

def test_reshard_flat_state_matches_the_jax_function():
    total = 10
    base = np.arange(total, dtype=np.float32)
    tree = {"buf": np.pad(base, (0, 6)), "scalar": np.float32(3.0),
            "other": np.ones((3, 3), np.float32),
            "moments": [np.pad(base * 2, (0, 6)), (np.pad(base, (0, 6)),)]}
    for old, new in ((8, 4), (8, 3), (4, 8)):
        src = reshard_flat_state(tree, total, 8, 8) if old != 8 else tree
        got = reshard_flat_state(src, total, old, new)
        want = jrecovery.reshard_flat_state(src, total, old, new)
        assert np.asarray(got["buf"]).shape == np.asarray(want["buf"]).shape
        for a, b in ((got["buf"], want["buf"]),
                     (got["moments"][0], want["moments"][0]),
                     (got["moments"][1][0], want["moments"][1][0]),
                     (got["other"], want["other"]),
                     (got["scalar"], want["scalar"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert isinstance(got["moments"][1], tuple)
    out = reshard_flat_state(tree, total, 8, 4)
    assert out["buf"].shape == (12,) and not out["buf"][total:].any()
    # tensor leaves stay tensors
    t = reshard_flat_state({"buf": torch.from_numpy(tree["buf"])}, total,
                           8, 4)["buf"]
    assert isinstance(t, torch.Tensor) and t.shape == (12,)
    np.testing.assert_array_equal(t.numpy(), out["buf"])
    with pytest.raises(ValueError):
        reshard_flat_state(tree, total, 0, 4)


def test_preemption_guard_sigterm_handler():
    ring = obs.EventRing(16)
    guard = PreemptionGuard(grace_s=5.0, ring=ring,
                            registry=obs.MetricsRegistry())
    prev = signal.getsignal(signal.SIGTERM)
    with guard:
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(400):
            if guard.requested:
                break
            time.sleep(0.005)
        assert guard.requested and "signal" in guard.reason
    assert signal.getsignal(signal.SIGTERM) is prev
    guard2 = PreemptionGuard(registry=obs.MetricsRegistry())
    guard2.install()
    guard2.install()
    guard2.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
    (ev,) = ring.snapshot("preemption_requested")
    assert ev["grace_s"] == 5.0
    t0 = guard.requested_at
    guard.preempt("again")
    assert guard.requested_at == t0 and "signal" in guard.reason


def _training_faults(pk):
    clk = TickClock()
    ring = pk.obs.EventRing(64, clock=clk)
    guard = pk.fleet.PreemptionGuard(ring=ring,
                                     registry=pk.obs.MetricsRegistry())
    tf = pk.fleet.TrainingFaults(replica_death=(3, 4), straggler=(1, 2),
                                 preemption=(5, 6), straggle_s=0.0,
                                 p_death=0.2, seed=3, ring=ring,
                                 guard=guard)
    events = []
    for step in range(12):
        try:
            tf.check_step(run_step=step)
            events.append("ok")
        except pk.fleet.ReplicaFault as e:
            events.append(str(e))
    return {"events": events, "fired": tf.faults_fired,
            "requested": guard.requested,
            "ring": [{k: v for k, v in e.items() if k != "t"}
                     for e in ring.snapshot()]}


def test_training_faults_twin():
    got = twin(_training_faults)
    assert got["requested"] and "injected replica death" in got["events"][3]
