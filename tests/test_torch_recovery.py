"""The port's elastic trainer against the JAX package's
(``tests/test_recovery.py`` is the spec), at 4 -> 2 gloo ranks against
4 -> 2 JAX CPU devices under ``shard_map``.

The ranks start once for the file (suite ``elastic`` of
``tests/torch_dist_worker.py``, 4 ranks, every trainer on an injected
constant clock so records compare whole).  Each rank runs a trainer;
rank 0 writes the snapshots and every rank restores them.

- replica death at step 5: the world shrinks 4 -> 2, the run resumes
  from the step-4 snapshot, the trajectory equals the JAX package's at
  rtol 1e-6 (the same fp32 math reduced in another order), and the
  survivors' post-shrink losses equal an undisturbed world-2 run from
  the same snapshot bitwise; the ``kind: recovery`` record equals the
  JAX package's and validates;
- a torn step-4 snapshot is skipped on every rank, the run falls back
  to step 2;
- a one-shot NaN batch: the supervisor's ``nan`` verdict rolls back once
  at the same world, and the committed state never trained through it
  (its in-step nonfinite counter is 0);
- a second death at world 2: 4 -> 2 -> 1, the barrier's groups made
  while every rank was there;
- ZeRO-1 under O2 + FusedAdam (tests/test_recovery.py's scenario at
  4 -> 2): the shards are redistributed onto the two survivors (the
  windows re-padded for 2); steps, worlds and the record equal the JAX
  package's run, the losses at rtol 2e-3 (O2's bf16 logits), and the
  post-shrink losses equal the port's undisturbed world-2 run from the
  same snapshot bitwise;
- a preemption at step 4 with a ``DataLoader``: the emergency snapshot,
  the clean exit, and a fresh trainer with ``resume=True`` that ends
  bitwise on the undisturbed run's losses and sample sequence (and on
  the JAX package's losses at rtol 1e-6);
- the three ``RecoveryError`` paths (single process, numpy state) raise
  the JAX package's messages.

A second start of 8 ranks (suite ``elastic_hier``) holds the 8 -> 4
shrinks in which the node shrinks with the world (4 -> 2), against
tests/test_recovery.py's scenarios on 8 -> 4 JAX CPU devices:

- ZeRO-2 (tests/test_recovery.py:365) and ZeRO-3 through a torn step-4
  snapshot (:467): O2 runs, the losses at ``ZERO_RTOL``, steps and
  worlds exact, the windows re-padded for the node of 2, and the
  post-shrink losses bitwise an undisturbed world-4 run of the port from
  the same snapshot;
- a replica death with a ``DataLoader`` (:684), over hierarchical DDP at
  both worlds: fp32, the losses at ``RTOL``, every committed step's
  samples drawn exactly once (160 consumed, the committed sample
  sequence an undisturbed loader's);
- hierarchical DDP and hierarchical Adasum over the shrunk world's group.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu import nn as jnn
from apex_tpu import observability as jobs
from apex_tpu import optimizers as joptim
from apex_tpu import parallel as jparallel
from apex_tpu.data import DataLoader as JLoader
from apex_tpu.fleet import ElasticConfig as JConfig
from apex_tpu.fleet import ElasticTrainer as JTrainer
from apex_tpu.fleet import PreemptionGuard as JGuard
from apex_tpu.fleet import RecoveryError as JRecoveryError
from apex_tpu.fleet import TrainingFaults as JFaults
from apex_tpu.fleet import reshard_flat_state as jreshard
from apex_tpu.nn import functional as JF

from apex_tpu_torch import fleet
from apex_tpu_torch import observability as obs
from apex_tpu_torch.observability.exporters import (JsonlExporter,
                                                    validate_recovery_record)

import torch_dist_worker
import torch_threads  # noqa: F401  (one torch thread a process)

RTOL = 1e-6
# the ZeRO-1 run is O2: the bf16 logits round differently in the two
# packages from the first step on (measured: 3.9e-4 relative at most),
# while a wrong window or padding moves the losses by whole percents
ZERO_RTOL = 2e-3


def CLOCK():
    return 0.0


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mlp(d_in=24, d_hid=16, d_out=10):
    net = jnn.Sequential([jnn.Flatten(), jnn.Linear(d_in, d_hid), jnn.ReLU(),
                          jnn.Linear(d_hid, d_out)])
    params, _ = net.init(jax.random.PRNGKey(0))
    return net, params


def _batches(n, b=16, d=24, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, d).astype(np.float32),
             rng.randint(0, 10, b).astype(np.int32)) for _ in range(n)]


def _uint8_dataset(n=64):
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (n, 4, 4, 3), np.uint8)
    return images, np.arange(n, dtype=np.int32)


def _ddp_build_step(model, ddp, lr=0.05):
    """tests/test_recovery.py's step on the first ``world`` devices."""
    def build_step(world):
        mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

        def step(state, batch):
            params, nan_steps = state
            xb, yb = batch

            def loss_fn(p):
                out, _ = model.apply(p, xb, train=True)
                return JF.cross_entropy(out, yb)

            loss, g = jax.value_and_grad(loss_fn)(params)
            g = ddp.allreduce_grads(g)
            params = jax.tree_util.tree_map(lambda p, gg: p - lr * gg,
                                            params, g)
            loss = lax.pmean(loss, "data")
            nan_steps = nan_steps + (~jnp.isfinite(loss)).astype(jnp.int32)
            return (params, nan_steps), loss

        return jax.jit(jax.shard_map(
            step, mesh=mesh, in_specs=(P(), (P("data"), P("data"))),
            out_specs=(P(), P()), check_vma=False))
    return build_step


def _jax_run(tmp, scenario, batches):
    model, params = _mlp()
    build = _ddp_build_step(model, jparallel.DistributedDataParallel(model))
    ring = jobs.EventRing(256, clock=CLOCK)
    sup = jobs.RunSupervisor(scenario, ring=ring, clock=CLOCK,
                             registry=jobs.MetricsRegistry())
    poisoned = {"done": False}

    def data_fn(i):
        x, y = batches[i]
        if scenario == "nan" and i == 6 and not poisoned["done"]:
            poisoned["done"] = True
            x = x.copy()
            x[0, 0] = np.nan
        return jnp.asarray(x), jnp.asarray(y)

    kw = {"death": dict(replica_death=(5, 6)),
          "double": dict(replica_death=((5, 6), (9, 10))),
          "torn": dict(replica_death=(5, 6), torn_checkpoint=(4, 5)),
          "nan": {}}[scenario]
    faults = JFaults(seed=0, ring=ring, **kw) if kw else None
    prev = jobs.set_ring(ring)
    try:
        tr = JTrainer(build, (params, jnp.zeros((), jnp.int32)), world=4,
                      ckpt_dir=str(tmp / scenario), to_host=_np_tree,
                      supervisor=sup, faults=faults,
                      config=JConfig(checkpoint_every=2, min_world=1),
                      ring=ring, registry=jobs.MetricsRegistry(),
                      run=scenario, clock=CLOCK)
        tr.run({"torn": 8}.get(scenario, 10), data_fn)
    finally:
        jobs.set_ring(prev)
    return tr, ring, sup


def _jax_zero_run(tmp, batches):
    """tests/test_recovery.py's ZeRO-1 scenario (O2 + FusedAdam, the
    optimizer state sharded over the data axis, a replica death at
    observed step 3) on 4 -> 2 devices."""
    net = jnn.Sequential([jnn.Flatten(), jnn.Linear(24, 10)])
    model, optimizer = jamp.initialize(
        net, joptim.FusedAdam(lr=1e-2), opt_level="O2", verbosity=0,
        hard_override=True)
    params, _ = model.init(jax.random.PRNGKey(0))
    ospecs = jamp.zero_optimizer_specs(optimizer, params, "data")
    total = optimizer.init(params).masters.buf.size

    def build_step(world):
        mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

        def step(state, batch):
            p, ost = state
            xb, yb = batch

            def loss_fn(pp):
                out, _ = model.apply(pp, xb, train=True)
                return JF.cross_entropy(out, yb)

            loss, g = jamp.scaled_grad(loss_fn, p, ost)
            p, ost, _ = optimizer.step(p, ost, g)
            return (p, ost), lax.pmean(loss, "data")

        return jax.jit(jax.shard_map(
            step, mesh=mesh,
            in_specs=((P(), ospecs), (P("data"), P("data"))),
            out_specs=((P(), ospecs), P()), check_vma=False))

    mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))
    opt0 = jax.jit(jax.shard_map(
        lambda pp: optimizer.init(pp, zero_axis="data"), mesh=mesh4,
        in_specs=(P(),), out_specs=ospecs, check_vma=False))(params)

    def to_host(state):
        p, ost = _np_tree(state)
        buf_len = ost.masters.buf.shape[0]
        old_world = next(w for w in (4, 2, 1)
                         if buf_len == total + (-total) % w)
        return (p, jreshard(ost, total, old_world, 1))

    def from_host(tree, world):
        p, ost = tree
        return (p, jreshard(ost, total, 1, world))

    tr = JTrainer(build_step, (params, opt0), world=4,
                  ckpt_dir=str(tmp / "zero"), to_host=to_host,
                  from_host=from_host,
                  faults=JFaults(replica_death=(3, 4), seed=0),
                  config=JConfig(checkpoint_every=1, min_world=1),
                  registry=jobs.MetricsRegistry(), run="zero_elastic",
                  clock=CLOCK)
    tr.run(7, lambda i: batches[i])
    return tr


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, mlp = _mlp()
    _, mlp48 = _mlp(48, 32, 64)
    zp, _ = jnn.Sequential([jnn.Flatten(), jnn.Linear(24, 10)]).init(
        jax.random.PRNGKey(0))
    images, labels = _uint8_dataset()
    inp = {"mlp": _np_tree(mlp), "mlp48": _np_tree(mlp48),
           "zero_w": np.asarray(zp["1"]["weight"]),
           "zero_b": np.asarray(zp["1"]["bias"]),
           "batches": _batches(12), "images": images, "labels": labels,
           "ckpt_root": str(tmp_path_factory.mktemp("elastic_ckpt"))}
    return inp, torch_dist_worker.run(
        "elastic", inp, tmp_path_factory.mktemp("elastic"), world=4)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, ranks):
    inp, _ = ranks
    tmp = tmp_path_factory.mktemp("jax_elastic")
    runs = {s: _jax_run(tmp, s, inp["batches"])
            for s in ("death", "double", "torn", "nan")}
    runs["zero"] = _jax_zero_run(tmp, inp["batches"])
    return runs


def _losses(hist):
    return np.array([loss for _, loss, _ in hist], np.float64)


def _json(x):
    return json.loads(json.dumps(x, sort_keys=True, default=repr))


def _ring(events, drop=("path", "duration_s", "seq", "t")):
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


@pytest.mark.parametrize("scenario", ["death", "double", "torn", "nan"])
def test_elastic_run_matches_jax(ranks, jax_runs, scenario):
    _, outs = ranks
    jtr, jring, jsup = jax_runs[scenario]
    want_world = {"death": 2, "double": 1, "torn": 2, "nan": 4}[scenario]
    recoveries = 2 if scenario == "double" else 1
    survivors = range(want_world)
    for rank in survivors:
        got = outs[rank][scenario]
        assert got["world"] == jtr.world == want_world
        assert got["recoveries"] == jtr.recoveries == recoveries
        assert got["resumed_step"] == jtr.resumed_step
        assert got["verdict"] == jtr.verdict == "completed"
        assert [(s, w) for s, _, w in got["history"]] == \
            [(s, w) for s, _, w in jtr.history]
        np.testing.assert_allclose(_losses(got["history"]),
                                   _losses(jtr.history), rtol=RTOL)
        assert _json(got["record"]) == _json(jtr.record())
        rec = JsonlExporter.enrich(got["record"])
        assert validate_recovery_record(rec) == []
        assert got["sup"]["health"][0] is True
        assert got["sup"]["recoveries"] == recoveries
    for rank in range(want_world, 4):
        assert outs[rank][scenario]["verdict"] == "left"
    rank0 = outs[0][scenario]
    if scenario == "death":
        assert rank0["resumed_step"] == 4
        assert [a["kind"] for a in rank0["record"]["actions"]] == \
            ["world_shrink", "resume"]
        assert _ring(rank0["ring"]) == _json(_ring(jring.snapshot()))
        for rank in (0, 1):
            post = [loss for _, loss, w in outs[rank]["death"]["history"]
                    if w == 2]
            assert post == outs[rank]["death"]["undisturbed"]
    elif scenario == "double":
        # 4 -> 2 at observed step 5 (back to the step-4 snapshot), then
        # 2 -> 1 at observed step 9 (back to step 6)
        assert rank0["resumed_step"] == 6
        assert [a["kind"] for a in rank0["record"]["actions"]] == \
            ["world_shrink", "resume"] * 2
        assert [(s, w) for s, _, w in rank0["history"]] == \
            [(s, 4) for s in range(5)] + [(s, 2) for s in (4, 5, 6)] + \
            [(s, 1) for s in range(6, 10)]
        assert _ring(rank0["ring"]) == _json(_ring(jring.snapshot()))
        assert [w for _, _, w in outs[1]["double"]["history"]][-1] == 2
    elif scenario == "torn":
        assert rank0["resumed_step"] == 2
        assert rank0["torn_paths"] == ["ckpt_00000004.npz"]
        for rank in range(4):
            skipped = [e["step"] for e in outs[rank]["torn"]["ring"]
                       if e["kind"] == "snapshot_skipped"]
            assert skipped == [4]
            assert not outs[rank]["torn"]["torn_paths"] or rank == 0
        # the npz files differ in their keys' names, so in their sizes;
        # the skip's reason names the file's path
        drop = ("path", "duration_s", "seq", "t", "bytes_kept",
                "bytes_total", "reason")
        assert _ring(rank0["ring"], drop) == \
            _json(_ring(jring.snapshot(), drop))
    else:
        assert rank0["resumed_step"] == 6
        assert [a["kind"] for a in rank0["record"]["actions"]] == \
            ["rollback"]
        for rank in range(4):
            got = outs[rank]["nan"]
            nan_rows = [s for s, loss, _ in got["history"]
                        if not np.isfinite(loss)]
            assert nan_rows == [6]
            assert got["nan_steps"] == 0 == int(jtr._state[1])
            assert got["sup"]["nan"] == 1 == \
                jsup.status()["anomaly_counts"]["nan"]


def test_zero1_shards_redistribute_onto_survivors(ranks, jax_runs):
    _, outs = ranks
    jtr = jax_runs["zero"]
    jbuf = int(jtr._state[1].masters.buf.shape[0])
    for rank in (0, 1):
        got = outs[rank]["zero"]
        assert got["world"] == jtr.world == 2
        assert got["resumed_step"] == jtr.resumed_step == 3
        assert [(s, w) for s, _, w in got["history"]] == \
            [(s, w) for s, _, w in jtr.history] == \
            [(s, 4) for s in range(3)] + [(s, 2) for s in range(3, 7)]
        np.testing.assert_allclose(_losses(got["history"]),
                                   _losses(jtr.history), rtol=ZERO_RTOL)
        assert _json(got["record"]) == _json(jtr.record())
        assert validate_recovery_record(
            JsonlExporter.enrich(got["record"])) == []
        total = got["total"]
        assert got["padded"] == total + (-total) % 2 == jbuf
        assert got["buf"] == got["padded"] // 2
        # and the port against itself: an undisturbed world-2 run from
        # the same snapshot
        post = [loss for _, loss, w in got["history"] if w == 2]
        assert post == got["undisturbed"]
        assert [a["kind"] for a in got["record"]["actions"]] == \
            ["world_shrink", "resume"]
    for rank in (2, 3):
        assert outs[rank]["zero"]["verdict"] == "left"


def test_preempt_resume_is_bitwise_undisturbed(ranks, tmp_path):
    inp, outs = ranks
    # the JAX package's undisturbed run on 4 devices
    images, labels = inp["images"], inp["labels"]
    net, params = _mlp(48, 32, 64)
    build = _ddp_build_step(net, jparallel.DistributedDataParallel(net))
    loader = JLoader(images, labels, batch_size=16, shuffle=True, seed=7,
                     native=False)

    def data_fn(i):
        imgs, lbls, _ = loader.next_batch()
        return jnp.asarray(imgs), jnp.asarray(lbls)
    jund = JTrainer(build, (params, jnp.zeros((), jnp.int32)), world=4,
                    ckpt_dir=str(tmp_path), to_host=_np_tree, data=loader,
                    config=JConfig(checkpoint_every=3, min_world=1),
                    registry=jobs.MetricsRegistry(), clock=CLOCK)
    jund.run(10, data_fn)
    for rank in range(4):
        got = outs[rank]["preempt"]
        und, pre, res = got["und"], got["pre"], got["res"]
        assert und["verdict"] == "completed"
        np.testing.assert_allclose(_losses(und["history"]),
                                   _losses(jund.history), rtol=RTOL)
        assert pre["verdict"] == "preempted" and pre["cause"] == \
            "preemption"
        assert [s for s, _, _ in pre["history"]] == list(range(5))
        assert [a["kind"] for a in pre["record"]["actions"]] == \
            ["preempt_snapshot"]
        assert pre["record"]["data_state"]["samples_consumed"] == 5 * 16
        assert validate_recovery_record(
            JsonlExporter.enrich(pre["record"])) == []
        kinds = [e["kind"] for e in pre["ring"]]
        for k in ("preemption_requested", "preempted", "run_preempted"):
            assert k in kinds, k
        assert pre["sup"]["preempted"] and pre["sup"]["health"][0]
        assert pre["sup"]["preempted_step"] == 5
        assert got["guard_wired"]
        assert res["resumed_step"] == 5 and res["verdict"] == "completed"
        assert res["overhead"] is not None and res["overhead"] >= 0
        assert [s for s, _, _ in res["history"]] == list(range(5, 10))
        assert [loss for _, loss, _ in pre["history"] + res["history"]] \
            == [loss for _, loss, _ in und["history"]]
        assert got["pre_log"] == got["und_log"]


# -- the loud failures --------------------------------------------------------

def _toy_build(world):
    return lambda st, b: ({"w": st["w"] + 1}, 1.0)


def _failure(pkg, tmp, kind):
    if pkg == "port":
        Trainer, Config, Faults, Err = (fleet.ElasticTrainer,
                                        fleet.ElasticConfig,
                                        fleet.TrainingFaults,
                                        fleet.RecoveryError)
        reg = obs.MetricsRegistry()
    else:
        Trainer, Config, Faults, Err = JTrainer, JConfig, JFaults, \
            JRecoveryError
        reg = jobs.MetricsRegistry()
    world, faults, cfg, steps = {
        "no_survivors": (1, dict(replica_death=(2, 3)),
                         dict(min_world=1), 6),
        "budget": (64, dict(replica_death=(2, None)),
                   dict(min_world=1, max_recoveries=2), 20),
        "no_durable": (4, dict(replica_death=(3, 4),
                               torn_checkpoint=(0, None)),
                       dict(checkpoint_every=1, min_world=1), 6)}[kind]
    tr = Trainer(_toy_build, {"w": np.zeros(2, np.float32)}, world=world,
                 ckpt_dir=str(tmp / pkg / kind), faults=Faults(seed=0,
                                                               **faults),
                 config=Config(**cfg), registry=reg, run=kind,
                 clock=lambda: 0.0)
    with pytest.raises(Err) as e:
        tr.run(steps, lambda i: None)
    msg = str(e.value).replace(str(tmp / pkg / kind), "<dir>")
    return msg, tr.recoveries, _json(tr.record())


@pytest.mark.parametrize("kind", ["no_survivors", "budget", "no_durable"])
def test_recovery_errors_match_jax(tmp_path, kind):
    got = _failure("port", tmp_path, kind)
    want = _failure("jax", tmp_path, kind)
    assert got == want
    assert {"no_survivors": "no survivors", "budget": "budget",
            "no_durable": "durable"}[kind] in got[0]


def test_config_errors_and_preempt_without_grace_match_jax(tmp_path):
    for kw in ({"checkpoint_every": 0}, {"shrink_factor": 1},
               {"min_world": 0}, {"max_recoveries": 0}):
        with pytest.raises(ValueError) as a:
            fleet.ElasticConfig(**kw)
        with pytest.raises(ValueError) as b:
            JConfig(**kw)
        assert str(a.value) == str(b.value)
    outs = []
    for pkg in ("port", "jax"):
        P_ = fleet if pkg == "port" else None
        ring = (obs if pkg == "port" else jobs).EventRing(64, clock=CLOCK)
        reg = (obs if pkg == "port" else jobs).MetricsRegistry
        guard = (P_.PreemptionGuard if P_ else JGuard)(
            grace_s=0.0, ring=ring, registry=reg(), clock=CLOCK)
        faults = (P_.TrainingFaults if P_ else JFaults)(
            preemption=(2, 3), seed=0, ring=ring)
        tr = (P_.ElasticTrainer if P_ else JTrainer)(
            _toy_build, {"w": np.zeros(2, np.float32)}, world=4,
            ckpt_dir=str(tmp_path / pkg), guard=guard, faults=faults,
            config=(P_.ElasticConfig if P_ else JConfig)(
                checkpoint_every=5, min_world=1),
            ring=ring, registry=reg(), run="nograce", clock=CLOCK)
        tr.run(6, lambda i: None)
        outs.append((tr.verdict, _json(tr.record()),
                     _ring(ring.snapshot())))
    assert _json(outs[0]) == _json(outs[1])
    assert outs[0][0] == "preempted"


# -- the 8 -> 4 shrinks with the node (suite "elastic_hier") ------------------

def _retree(ost, specs):
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(specs),
        jax.tree_util.tree_leaves(ost))


def _dedup_slices(ost, padded, dcn):
    def fix(a):
        if getattr(a, "ndim", 0) == 1 and a.shape[0] == dcn * padded:
            return a[:padded]
        return a
    return jax.tree_util.tree_map(fix, ost)


def _tile_slices(ost, padded, dcn):
    def fix(a):
        if getattr(a, "ndim", 0) == 1 and a.shape[0] == padded:
            return np.concatenate([np.asarray(a)] * dcn)
        return a
    return jax.tree_util.tree_map(fix, ost)


def _ici_of(world):
    return max(world // 2, 1)


def _jax_zero_hier_run(tmp, batches, stage):
    """tests/test_recovery.py:365 (stage 2) and :467 (stage 3), on 8 -> 4
    devices."""
    net = jnn.Sequential([jnn.Flatten(), jnn.Linear(24, 10)])
    model, optimizer = jamp.initialize(
        net, joptim.FusedAdam(lr=1e-2), opt_level="O2", verbosity=0,
        hard_override=True)
    params, _ = model.init(jax.random.PRNGKey(0))
    total = optimizer.init(params).masters.buf.size

    def ospecs_for(world):
        return jamp.zero_optimizer_specs(
            optimizer, params, "data", zero_stage=stage,
            zero_ici_size=_ici_of(world))

    def build_step(world):
        mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
        ospecs = ospecs_for(world)
        if stage == 3:
            def step(ost, batch):
                xb, yb = batch

                def loss_fn(m):
                    out, _ = model.apply(jamp.zero_gather_params(m), xb,
                                         train=True)
                    return JF.cross_entropy(out, yb)

                loss, g = jamp.scaled_grad(loss_fn, ost.masters, ost)
                _, ost, _ = optimizer.step((), ost, g)
                return ost, lax.pmean(loss, "data")
            specs = ospecs
        else:
            def step(state, batch):
                p, ost = state
                xb, yb = batch

                def loss_fn(pp):
                    out, _ = model.apply(pp, xb, train=True)
                    return JF.cross_entropy(out, yb)

                loss, g = jamp.scaled_grad(loss_fn, p, ost)
                p, ost, _ = optimizer.step(p, ost, g)
                return (p, ost), lax.pmean(loss, "data")
            specs = (P(), ospecs)
        return jax.jit(jax.shard_map(
            step, mesh=mesh, in_specs=(specs, (P("data"), P("data"))),
            out_specs=(specs, P()), check_vma=False))

    mesh8 = Mesh(np.array(jax.devices()[:8]), ("data",))
    ost0 = jax.jit(jax.shard_map(
        lambda pp: optimizer.init(pp, zero_axis="data", zero_stage=stage,
                                  zero_ici_size=_ici_of(8)),
        mesh=mesh8, in_specs=(P(),), out_specs=ospecs_for(8),
        check_vma=False))(params)

    def host_ost(ost):
        buf_len = ost.masters.buf.shape[0]
        old_ici = next(i for i in (4, 2, 1)
                       if buf_len == 2 * (total + (-total) % i))
        ost = _dedup_slices(ost, buf_len // 2, 2)
        return _retree(jreshard(ost, total, old_ici, 1), ospecs_for(2))

    def live_ost(ost, world):
        ici = _ici_of(world)
        ost = jreshard(ost, total, 1, ici)
        ost = _tile_slices(ost, total + (-total) % ici, world // ici)
        return _retree(ost, ospecs_for(world))

    if stage == 3:
        state0 = ost0
        to_host = lambda st: host_ost(_np_tree(st))  # noqa: E731
        from_host = live_ost
        faults = dict(replica_death=(5, 6), torn_checkpoint=(4, 5))
        every, steps = 2, 8
    else:
        state0 = (params, ost0)

        def to_host(st):
            p, ost = _np_tree(st)
            return (p, host_ost(ost))

        def from_host(tree, world):
            return (tree[0], live_ost(tree[1], world))
        faults, every, steps = dict(replica_death=(3, 4)), 1, 7
    ring = jobs.EventRing(256, clock=CLOCK)
    tr = JTrainer(build_step, state0, world=8,
                  ckpt_dir=str(tmp / f"zero{stage}"), to_host=to_host,
                  from_host=from_host,
                  faults=JFaults(seed=0, ring=ring, **faults),
                  config=JConfig(checkpoint_every=every, min_world=2),
                  ring=ring, registry=jobs.MetricsRegistry(),
                  run=f"zero{stage}_elastic", clock=CLOCK)
    tr.run(steps, lambda i: batches[i])
    return tr, ring, total


def _jax_loader_run(tmp, images, labels):
    """tests/test_recovery.py:684 on 8 -> 4 devices."""
    net, params = _mlp(48, 32, 64)
    build = _ddp_build_step(net, jparallel.DistributedDataParallel(net))
    loader = JLoader(images, labels, batch_size=16, shuffle=True, seed=7,
                     native=False)
    tr = JTrainer(build, (params, jnp.zeros((), jnp.int32)), world=8,
                  ckpt_dir=str(tmp / "loader"), to_host=_np_tree,
                  data=loader, faults=JFaults(replica_death=(5, 6), seed=0),
                  config=JConfig(checkpoint_every=2, min_world=1),
                  registry=jobs.MetricsRegistry(), run="death_loader",
                  clock=CLOCK)
    tr.run(10)
    return tr, loader


@pytest.fixture(scope="module")
def hier_ranks(tmp_path_factory):
    _, mlp48 = _mlp(48, 32, 64)
    zp, _ = jnn.Sequential([jnn.Flatten(), jnn.Linear(24, 10)]).init(
        jax.random.PRNGKey(0))
    images, labels = _uint8_dataset()
    rs = np.random.RandomState(22)
    inp = {"mlp48": _np_tree(mlp48),
           "zero_w": np.asarray(zp["1"]["weight"]),
           "zero_b": np.asarray(zp["1"]["bias"]),
           "batches": _batches(10), "images": images, "labels": labels,
           "g1001": rs.randn(1001).astype(np.float32),
           "ada_slices": rs.randn(2, 16).astype(np.float32),
           "ckpt_root": str(tmp_path_factory.mktemp("elastic_hier_ckpt"))}
    return inp, torch_dist_worker.run(
        "elastic_hier", inp, tmp_path_factory.mktemp("elastic_hier"),
        world=8)


@pytest.mark.parametrize("stage", [2, 3])
def test_zero_hier_shards_shrink_with_the_node(hier_ranks, tmp_path, stage):
    """ZeRO-2 (tests/test_recovery.py:365) and ZeRO-3 through a torn
    snapshot (:467), 8 -> 4 with the node 4 -> 2; losses at ZERO_RTOL
    (O2), the port's post-shrink run bitwise its undisturbed one."""
    inp, outs = hier_ranks
    jtr, jring, jtotal = _jax_zero_hier_run(tmp_path, inp["batches"], stage)
    resume = {2: 3, 3: 2}[stage]
    last = {2: 6, 3: 7}[stage]
    assert jtr.world == 4 and jtr.resumed_step == resume
    assert jtr.history[-1][0] == last
    jbuf = int(jtr._state[1].masters.buf.shape[0] if stage == 2
               else jtr._state.masters.buf.shape[0])
    for rank in range(4):
        got = outs[rank][f"zero{stage}"]
        assert got["world"] == 4 and got["verdict"] == "completed"
        assert got["resumed_step"] == resume
        assert [(s, w) for s, _, w in got["history"]] == \
            [(s, w) for s, _, w in jtr.history]
        np.testing.assert_allclose(_losses(got["history"]),
                                   _losses(jtr.history), rtol=ZERO_RTOL)
        assert _json(got["record"]) == _json(jtr.record())
        assert validate_recovery_record(
            JsonlExporter.enrich(got["record"])) == []
        # the windows re-padded for the node of 2: the JAX global view is
        # two nodes' copies of it
        total = got["total"]
        assert total == jtotal
        assert got["shards"] == got["ici"] == _ici_of(4) == 2
        assert got["padded"] == total + (-total) % 2 == jbuf // 2
        assert got["buf"] == got["padded"] // 2
        assert got["group_ranks"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        post = [loss for _, loss, w in got["history"] if w == 4]
        assert post == got["undisturbed"]
    for rank in range(4, 8):
        assert outs[rank][f"zero{stage}"]["verdict"] == "left"
    if stage == 3:
        for rank in range(8):
            skipped = [e["step"] for e in outs[rank]["zero3"]["ring"]
                       if e["kind"] == "snapshot_skipped"]
            assert skipped == [4]
        assert [e["step"] for e in jring.snapshot()
                if e["kind"] == "snapshot_skipped"] == [4]


def test_replica_death_with_loader_over_hierarchical_ddp(hier_ranks,
                                                         tmp_path):
    """tests/test_recovery.py:684, each of 8 ranks a trainer over
    hierarchical DDP: fp32 losses at RTOL against the JAX package's flat
    run (a sum in another order), the census exactly once."""
    inp, outs = hier_ranks
    jtr, jloader = _jax_loader_run(tmp_path, inp["images"], inp["labels"])
    assert jtr.world == 4 and jtr.resumed_step == 4
    assert jloader.stats()["samples_consumed"] == 10 * 16
    # an undisturbed loader's first ten batches: what each committed step
    # must have drawn
    from apex_tpu_torch.data import DataLoader
    fleet_loader = DataLoader(inp["images"], inp["labels"], batch_size=16,
                              shuffle=True, seed=7, native=False)
    ref = [[int(v) for v in fleet_loader.next_batch()[1]]
           for _ in range(10)]
    for rank in range(4):
        got = outs[rank]["loader"]
        assert got["world"] == 4 and got["resumed_step"] == 4
        assert got["verdict"] == "completed"
        assert [(s, w) for s, _, w in got["history"]] == \
            [(s, w) for s, _, w in jtr.history]
        np.testing.assert_allclose(_losses(got["history"]),
                                   _losses(jtr.history), rtol=RTOL)
        assert _json(got["record"]) == _json(jtr.record())
        assert got["consumed"] == 10 * 16 and got["ds_consumed"] == 4 * 16
        # the draws: steps 0-5 (the one at the death abandoned), then the
        # rewind to the step-4 cursor and steps 4-9
        assert got["log"] == ref[:6] + ref[4:]
        committed = ref[:4] + got["log"][6:]
        assert committed == ref
        counts = np.bincount(np.concatenate(committed), minlength=64)
        # 160 draws over 64 samples: each epoch takes every sample once
        assert counts.sum() == 160 and set(counts) <= {2, 3}
        assert list(np.bincount(np.concatenate(ref[:4]), minlength=64)) \
            == [1] * 64
        post = [loss for _, loss, w in got["history"] if w == 4]
        assert post == got["undisturbed"]
    for rank in range(4, 8):
        assert outs[rank]["loader"]["verdict"] == "left"


def test_hierarchical_ddp_and_adasum_over_a_shrunk_group(hier_ranks):
    """The first 4 of 8 ranks as a group with nodes of 2: the hierarchical
    mean is the flat one's, and hierarchical Adasum is the JAX package's
    on 4 devices with ici_size=2."""
    from apex_tpu.parallel import adasum as jadasum
    inp, outs = hier_ranks
    g = inp["g1001"]
    per = inp["ada_slices"]

    def fn(_):
        gg = {"w": jnp.asarray(per)[lax.axis_index("data") // 2]}
        return jadasum.adasum_grads(gg, "data", ici_size=2)["w"]

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    want = np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P("data"), out_specs=P(),
        check_vma=False))(jnp.arange(4.0)))
    for rank in range(4):
        got = outs[rank]["subgroup"]
        np.testing.assert_allclose(got["hier"][0], g * 2.5, rtol=1e-6)
        np.testing.assert_allclose(got["hier"][0], got["flat"][0],
                                   rtol=1e-6)
        assert [s["topology"] for s in got["hier_stats"]] == \
            ["hierarchical"]
        plan = jparallel.allreduce_comm_plan(
            [jnp.zeros(g.shape)], comm_topology="hierarchical", ici_size=2,
            world=4, nproc=1)
        for key in ("wire_elements", "padded_elements", "ici_wire_bytes",
                    "dcn_wire_bytes"):
            assert got["hier_stats"][0][key] == plan[0][key], key
        np.testing.assert_allclose(got["adasum_hier"], want, rtol=2e-5)
        # node-identical grads: the hierarchy is bitwise the flat butterfly
        np.testing.assert_array_equal(got["adasum_hier"],
                                      got["adasum_flat"])
    for rank in range(4, 8):
        assert outs[rank]["subgroup"] == {}
