"""The port's compilation ledger (``apex_tpu_torch/observability/
compilation.py``) against the JAX package's
(``apex_tpu/observability/compilation.py``).

- The retrace differ: the cases of ``tests/test_compilation.py:32-88``
  give the same verdicts on both sides.
- The ledger: one ``record_trace`` sequence gives equal ``snapshot()``
  counts, causes, last retraces and ring events (times masked).
- The entries: a tiny GPT ``Engine`` on each side, warmed, traces exactly
  its compile census once; N windows of mixed traffic add 0; a fleet of
  two warms 4 traces, its second replica's cause ``new_closure``, and a
  failover adds 0 (the JAX twins: ``tests/test_serving.py:983-1099``,
  ``tests/test_fleet.py:1264-1318``).  On the CPU the port records each
  graph's first call, where the card records its capture.
- The supervisor's storm verdicts over each ledger's own ``xla_retrace``
  events are equal: sequential engines do not storm
  (``tests/test_compilation.py:322``), a function retraced at three
  shapes does.
- A captured step refuses a batch of another shape, naming the culprit
  as the differ names it; ``make_step`` on the CPU records its first call;
  the kernel builds are ``nvcc:<name>`` entries.
"""

import json

import numpy as np
import pytest
import torch

import jax

from apex_tpu import serving as jserving
from apex_tpu.fleet import Fleet as JFleet
from apex_tpu.fleet import FaultyReplica as JFaulty
from apex_tpu.fleet import HealthConfig as JHealth
from apex_tpu.fleet import RetryPolicy as JRetry
from apex_tpu.observability import compilation as JC
from apex_tpu.observability import flightrec as jflightrec
from apex_tpu.observability import EventRing as JRing
from apex_tpu.observability import MetricsRegistry as JRegistry
from apex_tpu.observability import RunSupervisor as JSupervisor
from apex_tpu.observability import SupervisorConfig as JSupConfig

from apex_tpu_torch import _graph, parallel, serving
from apex_tpu_torch.fleet import FaultyReplica, Fleet, HealthConfig
from apex_tpu_torch.fleet import RetryPolicy
from apex_tpu_torch.observability import compilation as C
from apex_tpu_torch.observability import flightrec
from apex_tpu_torch.observability import (EventRing, MetricsRegistry,
                                          RunSupervisor, SupervisorConfig)

import torch_serving_util as su
import torch_threads  # noqa: F401  (one torch thread a process)


def _sig(**args):
    out = {}
    for name, spec in args.items():
        if isinstance(spec, tuple) and spec and spec[0] == "static":
            out[name] = {"static": spec[1]}
        else:
            out[name] = {"leaves": spec}
    return out


DIFFER_CASES = [
    (_sig(ids=[["int32", [4, 32]]], cache=[["bfloat16", [4, 2, 32, 8]]]),
     _sig(ids=[["int32", [4, 48]]], cache=[["bfloat16", [4, 2, 32, 8]]])),
    (_sig(ids=[["int32", [4, 32]]], cache=[["bfloat16", [4, 8]]]),
     _sig(ids=[["int32", [4, 32]]], cache=[["float32", [4, 8]]])),
    (_sig(x=[["float32", [8]]], n=("static", "3")),
     _sig(x=[["float32", [8]]], n=("static", "4"))),
    (_sig(ids=[["int32", [4, 32]]], n=("static", "3")),
     _sig(ids=[["int32", [4, 32]]], n=("static", "3"))),
    (_sig(a=[["float32", [4]]], b=[["float32", [4]]], c=("static", "1")),
     _sig(a=[["float32", [5]]], b=[["int32", [4]]], c=("static", "2"))),
    (_sig(x=[["float32", [4, 8]]]), _sig(x=[["bfloat16", [4, 9]]])),
    (_sig(x=[["float32", [4, 8]]]),
     _sig(x=[["float32", [4, 8]]], y=[["int32", []]])),
    (_sig(x=[["float32", [], "weak"]]), _sig(x=[["float32", []]])),
]


@pytest.mark.parametrize("prev,cur", DIFFER_CASES)
def test_differ_verdicts_equal_jax(prev, cur):
    assert C.diff_signatures(prev, cur) == JC.diff_signatures(prev, cur)
    for arg in cur.values():
        assert C.format_signature(arg) == JC.format_signature(arg)
    assert C.signature_fingerprint("e", cur) == \
        JC.signature_fingerprint("e", cur)


def test_constants_equal_jax():
    assert C.RETRACE_CAUSES == JC.RETRACE_CAUSES
    assert C.SIGNATURE_CHANGE_CAUSES == JC.SIGNATURE_CHANGE_CAUSES
    assert C.BENCH_COMPILE_FIELDS == JC.BENCH_COMPILE_FIELDS


# one record_trace sequence: every cause, two entries, interleaved closures
RECORD_SEQUENCE = [
    ("engine._step_k", _sig(ids=[["int32", [4, 32]]]), 0),
    ("engine._step_k", _sig(ids=[["int32", [4, 48]]]), 0),
    ("engine._step_k", _sig(ids=[["int32", [4, 48]]]), 1),
    ("engine._step_k", _sig(ids=[["int32", [4, 48]]]), 1),
    ("engine._prefill_slot", _sig(ids=[["int32", [4, 32]]],
                                  slot=("static", "0")), 0),
    ("engine._prefill_slot", _sig(ids=[["int32", [4, 32]]],
                                  slot=("static", "1")), 0),
    ("engine._step_k", _sig(ids=[["bfloat16", [4, 48]]]), 1),
    ("engine._step_k", _sig(ids=[["int32", [2, 16]]]), 2),
]


def _masked(obj):
    """A snapshot or ring event with its clock fields masked."""
    if isinstance(obj, dict):
        return {k: ("t" if k in ("t", "t_s", "uptime_s", "last_trace_t_s")
                    else _masked(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def test_record_sequence_equals_jax():
    tl = C.CompilationLedger(registry=MetricsRegistry(),
                             ring=EventRing(capacity=64))
    jl = JC.CompilationLedger(registry=JRegistry(),
                              ring=JRing(capacity=64))
    for entry, sig, cid in RECORD_SEQUENCE:
        te = tl.record_trace(entry, sig, closure_id=cid)
        je = jl.record_trace(entry, sig, closure_id=cid)
        assert _masked(te) == _masked(je)
    ts, js = tl.snapshot(), jl.snapshot()
    assert _masked(ts) == _masked(js)
    assert ts["entries"]["engine._step_k"]["causes"] == {
        "new_entry": 1, "shape": 1, "new_closure": 2, "repeat": 1,
        "dtype": 1}
    tr = [_masked(e) for e in tl.ring.snapshot()]
    jr = [_masked(e) for e in jl.ring.snapshot()]
    assert tr == jr and [e["kind"] for e in tr] == ["xla_retrace"] * 3
    for name in ("xla_traces_total", "xla_retraces_total"):
        tm, jm = tl.registry.get(name), jl.registry.get(name)
        assert {k: v.value for k, v in tm._children.items()} == \
            {k: v.value for k, v in jm._children.items()}
    json.dumps(ts)


def test_instrumented_function_traces_per_signature():
    """An eager function under the ledger records its first call at each
    new signature (jit's cache): the same counts and causes as the JAX
    wrapper over the same calls."""
    reg, ring = MetricsRegistry(), EventRing(capacity=16)
    led = C.CompilationLedger(registry=reg, ring=ring)
    jled = JC.CompilationLedger(registry=JRegistry(), ring=JRing(16))
    f = C.instrumented_jit(lambda x, n: x * n, "toy", ledger=led,
                           static_argnums=(1,))
    jf = JC.instrumented_jit(lambda x, n: x * n, "toy", ledger=jled,
                             static_argnums=(1,))
    for shape, n in (((4,), 2), ((4,), 2), ((5,), 2), ((4,), 3),
                     ((4,), 2)):
        out = f(torch.ones(shape), n)
        jout = jf(jax.numpy.ones(shape), n)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    t, j = led.snapshot()["entries"]["toy"], \
        jled.snapshot()["entries"]["toy"]
    for k in ("traces", "retraces", "compiles", "causes"):
        assert t[k] == j[k], k
    assert t["cache"] == {"hit": 0, "miss": 0, "uncached": 3}
    assert f.entry == "toy" and f.closure.closure_id == f.closure_id


# -- the engines and the fleet --------------------------------------------------

@pytest.fixture(scope="module")
def gpt():
    return su.gpt(0)


def _warm_delta(led, eng):
    before, t0 = led.counts(), led.total_traces()
    eng.warmup()
    after = led.counts()
    return (led.total_traces() - t0,
            {e: after.get(e, 0) - before.get(e, 0) for e in after
             if after.get(e, 0) != before.get(e, 0)})


def _traffic(eng, seed=0):
    rng = np.random.RandomState(seed)
    rids = [eng.submit([int(t) for t in rng.randint(0, 64, n)],
                       max_new_tokens=m)
            for n, m in ((5, 6), (9, 4), (3, 8), (7, 3))]
    windows = 0
    while eng.live() or eng.queue_depth():
        eng.step()
        windows += 1
    assert all(eng.is_finished(r) for r in rids)
    return windows


@pytest.mark.parametrize("kind", ["fixed", "paged", "seq2seq"])
def test_warmup_traces_exactly_the_census(gpt, kind):
    """Warmup traces each census entry once on both sides, a second
    warmup nothing, and mixed traffic nothing."""
    if kind == "seq2seq":
        jm, params, tm = su.t5(50)
        kw = dict(slots=2, src_len=12, max_new_cap=10)
        jeng = jserving.Seq2SeqEngine(jm, params, **kw)
        teng = serving.Seq2SeqEngine(tm, **kw)
    else:
        jm, params, tm = gpt
        kw = dict(slots=3, buf_len=su.BUF, window=2)
        if kind == "paged":
            kw.update(block_size=8, prefill_chunk=8)
        cls = "PagedEngine" if kind == "paged" else "Engine"
        jeng = getattr(jserving, cls)(jm, params, **kw)
        teng = getattr(serving, cls)(tm, **kw)
    census = teng.compile_census()
    assert census == jeng.compile_census()
    warm = {e for e, st in census.items() if st in ("admission", "decode")}
    got = [_warm_delta(C.get_ledger(), teng),
           _warm_delta(JC.get_ledger(), jeng)]
    assert got[0] == got[1] == (len(warm), {e: 1 for e in warm})
    assert _warm_delta(C.get_ledger(), teng) == (0, {})
    led = C.get_ledger()
    t0 = led.total_traces()
    if kind != "seq2seq":
        assert _traffic(teng) >= 3
    else:
        for src, n in (([3, 4, 5], 4), ([9] * 8, 2), ([2, 7], 6)):
            teng.submit(src, max_new_tokens=n)
        while teng.live() or teng.queue_depth():
            teng.step()
    assert led.total_traces() - t0 == 0
    assert teng.captures == {}              # the CPU captures nothing


def test_second_engine_is_new_closure_on_both_sides(gpt):
    jm, params, tm = gpt
    tled, jled = C.get_ledger(), JC.get_ledger()
    causes = []
    for led, eng in ((tled, serving.Engine(tm, slots=2, buf_len=su.BUF)),
                     (jled, jserving.Engine(jm, params, slots=2,
                                            buf_len=su.BUF))):
        eng.warmup()
        ent = led.snapshot()["entries"]["engine._step_k"]
        causes.append(ent["events"][-1]["cause"])
    assert causes == ["new_closure", "new_closure"]


def _fleet_runs(make_engine, fleet_cls, faulty, health, retry, led):
    """A fleet of two warmed: traces of its warmup, then of traffic with
    replica 0 dying mid-run (the failover)."""
    bad = faulty(make_engine(), raise_on_step=(3, None))
    fl = fleet_cls([bad, make_engine()], policy="round_robin",
                   health=health(dead_consecutive=2, cooldown_steps=50),
                   retry=retry(max_attempts=6, jitter=0.0))
    t0 = led.total_traces()
    fl.warmup()
    warm = led.total_traces() - t0
    t1 = led.total_traces()
    rng = np.random.RandomState(1)
    rids = [fl.submit([int(t) for t in rng.randint(0, 64,
                                                   int(rng.randint(3, 9)))],
                      max_new_tokens=7) for _ in range(6)]
    n = 0
    while fl.live():
        fl.step()
        n += 1
        assert n < 300
    s = fl.stats()
    assert s["failovers"] >= 1 and s["failed"] == 0
    assert all(fl.status(r) == "finished" for r in rids)
    return warm, led.total_traces() - t1


def test_fleet_warmup_and_failover_trace_alike(gpt):
    jm, params, tm = gpt
    port = _fleet_runs(lambda: serving.Engine(tm, slots=2, buf_len=su.BUF),
                       Fleet, FaultyReplica, HealthConfig, RetryPolicy,
                       C.get_ledger())
    ref = _fleet_runs(lambda: jserving.Engine(jm, params, slots=2,
                                              buf_len=su.BUF),
                      JFleet, JFaulty, JHealth, JRetry, JC.get_ledger())
    # 2 replicas x (prefill + step); the survivors compile nothing
    assert port == ref == (4, 0)


# -- the supervisor over each ledger's events -------------------------------------

def _storm_verdicts(pkg):
    """Three differently-shaped engines built back to back, then one
    function retraced at three shapes: the supervisor's
    recompilation_storm count after each phase."""
    (ring_cls, sup_cls, cfg_cls, fr, comp, make_engine, make_x) = pkg
    ring = ring_cls(capacity=256)
    prev = fr.set_ring(ring)
    led_prev = comp.set_ledger(comp.CompilationLedger(ring=ring))
    try:
        sup = sup_cls("t", ring=ring, config=cfg_cls(
            storm_retraces=3, storm_window_observations=20))
        found = []
        for i, (buf, win) in enumerate(((16, 1), (16, 8), (24, 2))):
            make_engine(i, buf, win).warmup()
            found.append(sup.observe_step(step=i, loss=1.0))
        f = comp.instrumented_jit(lambda x: x + 1, "storm.fn")
        for i, n in enumerate((4, 5, 6, 7)):
            f(make_x(n))
            found.append(sup.observe_step(step=3 + i, loss=1.0))
        kinds = [[a["kind"] for a in fs] for fs in found]
        return kinds, sup._counts["recompilation_storm"]
    finally:
        fr.set_ring(prev)
        comp.set_ledger(led_prev)


def test_storm_verdicts_equal_jax():
    from apex_tpu import models as jmodels
    from apex_tpu_torch import models

    def jengine(i, buf, win):
        m = jmodels.GPT(jmodels.GPTConfig(vocab_size=64, block_size=buf,
                                          n_layer=1, n_head=2, n_embd=16,
                                          dropout=0.0))
        p, _ = m.init(jax.random.PRNGKey(i))
        return jserving.Engine(m, p, slots=2, buf_len=buf, window=win)

    def tengine(i, buf, win):
        m = models.GPT(models.GPTConfig(vocab_size=64, block_size=buf,
                                        n_layer=1, n_head=2, n_embd=16,
                                        dropout=0.0), device="cpu")
        return serving.Engine(m, slots=2, buf_len=buf, window=win)

    port = _storm_verdicts((EventRing, RunSupervisor, SupervisorConfig,
                            flightrec, C, tengine, torch.ones))
    ref = _storm_verdicts((JRing, JSupervisor, JSupConfig, jflightrec, JC,
                           jengine, jax.numpy.ones))
    assert port == ref
    kinds, storms = port
    assert kinds[:3] == [[], [], []]        # sequential engines: no storm
    assert storms == 1                      # three shape retraces: one


# -- the captured step, make_step, the kernel builds -------------------------------

def test_refused_batch_names_the_culprit():
    reg, ring = MetricsRegistry(), EventRing(capacity=16)
    led = C.CompilationLedger(registry=reg, ring=ring)
    step = _graph.CapturedStep(lambda b: b["x"] * 2, 1, torch.device("cpu"))
    C.instrumented_jit(step, "step.toy", ledger=led)
    batch = {"x": torch.ones(4, 8), "y": torch.zeros(4, dtype=torch.int64)}
    # what the capture records on the card, stood in for on the CPU
    step.static_batch = batch
    step.signature = _graph._batch_signature(batch)
    step.closure.record(step.signature, 0.5)
    want = JC.diff_signatures(
        {"batch": {"leaves": [["float32", [4, 8]], ["int64", [4]]]}},
        {"batch": {"leaves": [["float32", [5, 8]], ["int64", [5]]]}})
    for _ in range(2):
        with pytest.raises(ValueError, match=r"batch \(shape\): "
                           r"f32\[4,8\] i64\[4\] -> f32\[5,8\] i64\[5\]"):
            step._feed({"x": torch.ones(5, 8),
                        "y": torch.zeros(5, dtype=torch.int64)})
    ent = led.snapshot()["entries"]["step.toy"]
    assert ent["causes"] == {"new_entry": 1, "shape": 2}
    assert ent["compiles"] == 1 and ent["last_retrace"]["culprit"] == "batch"
    evs = ring.snapshot(kind="xla_retrace")
    assert [(e["culprit"], e["before"], e["after"]) for e in evs] == \
        [("batch", want[0]["before"], want[0]["after"])] * 2
    # an uninstrumented step names its culprit too
    step2 = _graph.CapturedStep(lambda b: b, 1, torch.device("cpu"))
    step2.static_batch = torch.ones(2)
    step2.signature = _graph._batch_signature(torch.ones(2))
    with pytest.raises(ValueError, match=r"batch \(dtype\): f32\[2\] -> "
                       r"f64\[2\]"):
        step2._feed(torch.ones(2, dtype=torch.float64))


def test_make_step_records_its_first_call_on_the_cpu():
    net = torch.nn.Linear(4, 2)
    led = C.CompilationLedger(registry=MetricsRegistry(),
                              ring=EventRing(capacity=8))
    prev = C.set_ledger(led)
    try:
        train = parallel.make_step(lambda b: net(b).sum(), net)
        for _ in range(3):
            train(torch.ones(3, 4))
        train(torch.ones(5, 4))
    finally:
        C.set_ledger(prev)
    ent = led.snapshot()["entries"]["make_step"]
    assert ent["causes"] == {"new_entry": 1, "shape": 1}
    assert ent["events"][1]["culprit"] == "batch"


def test_kernel_builds_are_nvcc_entries():
    led = C.CompilationLedger(registry=MetricsRegistry(),
                              ring=EventRing(capacity=8))
    C.record_build("adam", 12.5, hit=False, ledger=led)
    C.record_build("lamb", 0.0, hit=True, ledger=led)
    snap = led.snapshot()
    assert snap["entries"]["nvcc:adam"]["cache"]["miss"] == 1
    assert snap["entries"]["nvcc:adam"]["compile_wall_s"] == 12.5
    assert snap["entries"]["nvcc:lamb"]["cache"]["hit"] == 1
    assert snap["totals"]["cache_misses"] == 1
    assert snap["totals"]["cache_hits"] == 1
    assert led.compile_wall_s() == 12.5
