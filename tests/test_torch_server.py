"""The port's introspection server (``apex_tpu_torch/observability/
server.py``) against the JAX package's
(``apex_tpu/observability/server.py``).

- Over an equally seeded registry, flight ring, span recorder, ledger,
  status, health and tenant sources, every JSON endpoint's body equals
  the JAX server's (clock fields, trace ids and the pid masked), with
  its filters, and ``/metricsz`` is byte-equal.
- A failing health check turns ``/healthz`` into 503 on both sides;
  ``/profilez`` answers 404 with no hook, 409 with a window open, 400 on
  a bad duration and 200 with the hook's record.
- A live scrape of a running port ``Fleet`` (two engines) serves every
  endpoint while it steps, ``/compilez`` listing the engines' census;
  ``/profilez`` with ``timeline.make_profiler`` captures a window of its
  traffic.
- A profiler window opens and closes only between the holds of
  ``utils.profiler.launch_guard`` (what every engine launch and graph
  replay holds): it waits for a hold in flight, new holds wait for it,
  a thread's nested holds never wait, and a window opened inside a hold
  does not wait for itself.
- ``tests/ci/server_smoke_torch.py``, the port's form of
  ``tests/ci/server_smoke.py``, passes as a subprocess.
"""

import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

from apex_tpu import observability as jobs
from apex_tpu.observability import compilation as jcompilation
from apex_tpu.observability import server as jserver

from apex_tpu_torch import observability as obs
from apex_tpu_torch import serving
from apex_tpu_torch.fleet import Fleet
from apex_tpu_torch.observability import compilation, exporters, server
from apex_tpu_torch.observability import timeline

import torch_serving_util as su
import torch_threads  # noqa: F401  (one torch thread a process)


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


_CLOCK = {"uptime_s", "t", "ts", "t_s", "last_trace_t_s", "dur", "pid",
          "start_s", "end_s", "duration_s", "wall_s", "time", "host",
          "hostname", "timestamp", "created_s", "started_s", "requests"}
_TRACE_ID = re.compile(r"[0-9a-f]{8,}")


def _masked(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in _CLOCK else _masked(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    if isinstance(obj, str):
        return _TRACE_ID.sub("<id>", obj)
    return obj


BUCKET = {"submitted": 3, "finished": 2, "failed": 0, "shed": 1,
          "deadline_exceeded": 0, "slo_misses": 0, "goodput_tokens": 32,
          "with_deadline": 2, "within_deadline": 2, "slo_attainment": 1.0,
          "goodput_tokens_per_s": 12.5}


def _seeded(pkg, comp, srv_mod):
    """A server over one package's structures, seeded by the same calls
    on both sides."""
    reg = pkg.MetricsRegistry()
    reg.counter("smoke_requests_total",
                help="requests with a \\ backslash").labels(
        route='/v1/"generate"\npath', shard="a\\b").inc(5)
    reg.gauge("smoke_occupancy").set(0.75)
    h = reg.histogram("smoke_latency_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 5.0):
        h.observe(v)
    ring = pkg.EventRing(capacity=6)
    for i in range(5):
        ring.append("smoke_event", i=i)
    ring.append("shed", queue_depth=4, max_queue=4, tenant="acme")
    ring.append("failover", replica=0, tenants=["acme", "zeta"])
    rec = pkg.SpanRecorder()
    tid = "smoke-0123456789abcdef"
    root = rec.event("submit", trace_id=tid)
    rec.event("dispatch", trace_id=tid, parent_id=root)
    led = comp.CompilationLedger(registry=reg, ring=ring)
    led.record_trace("engine._step_k",
                     {"ids": {"leaves": [["int32", [4, 32]]]}},
                     closure_id=0)
    led.record_trace("engine._step_k",
                     {"ids": {"leaves": [["int32", [4, 48]]]}},
                     closure_id=0)
    led.record_trace("engine._prefill_slot",
                     {"ids": {"leaves": [["int32", [4, 32]]]}},
                     closure_id=1)
    ok = {"flag": True}
    srv = srv_mod.ObservabilityServer(
        registry=reg, ring=ring, recorder=rec, ledger=led,
        status={"run": lambda: {"run": "smoke", "steps": 3},
                "boom": lambda: (_ for _ in ()).throw(
                    RuntimeError("seeded source failure"))},
        health={"run": lambda: (ok["flag"], "steps advancing")},
        tenants={"fleet": lambda: {
            "tenants": {"acme": dict(BUCKET), "zeta": dict(BUCKET)},
            "classes": {"interactive": dict(BUCKET, weight=8),
                        "batch": dict(BUCKET, weight=1)},
            "tenants_dropped": 0}})
    return srv, ok, tid


URLS = ["/healthz", "/statusz", "/flightz", "/flightz?kind=shed",
        "/flightz?tenant=acme", "/flightz?tenant=nobody", "/tracez",
        "/tracez?trace_id={tid}", "/tracez?trace_id=nope", "/compilez",
        "/compilez?entry=engine._step_k", "/compilez?entry=nope",
        "/tenantz", "/tenantz?tenant=acme", "/tenantz?class=batch",
        "/tenantz?tenant=acme&class=interactive", "/tenantz?class=nope",
        "/profilez", "/profilez?duration_ms=bogus", "/", "/nope"]


@pytest.fixture(scope="module")
def servers():
    port, pok, tid = _seeded(obs, compilation, server)
    ref, rok, _ = _seeded(jobs, jcompilation, jserver)
    port.start()
    ref.start()
    try:
        yield port, ref, (pok, rok), tid
    finally:
        port.stop()
        ref.stop()


@pytest.mark.parametrize("url", URLS)
def test_json_endpoints_equal_jax(servers, url):
    port, ref, _, tid = servers
    url = url.format(tid=tid)
    pc, pt, pb = _get(port.url + url)
    rc, rt, rb = _get(ref.url + url)
    assert (pc, pt) == (rc, rt)
    assert _masked(json.loads(pb)) == _masked(json.loads(rb))


def test_metricsz_byte_equal(servers):
    port, ref, _, _ = servers
    pc, pt, pb = _get(port.url + "/metricsz")
    rc, rt, rb = _get(ref.url + "/metricsz")
    assert (pc, pt, pb) == (rc, rt, rb)
    assert exporters.validate_prometheus_text(pb.decode()) == []
    assert server.ENDPOINTS == jserver.ENDPOINTS


def test_failed_check_is_503_on_both_sides(servers):
    port, ref, oks, _ = servers
    for ok in oks:
        ok["flag"] = False
    try:
        pc, _, pb = _get(port.url + "/healthz")
        rc, _, rb = _get(ref.url + "/healthz")
        assert pc == rc == 503
        assert _masked(json.loads(pb)) == _masked(json.loads(rb))
        assert json.loads(pb)["status"] == "unhealthy"
    finally:
        for ok in oks:
            ok["flag"] = True


def test_profilez_404_409_400_200():
    fake = {"metric": "fake_capture", "span_ms": 2.0,
            "device_busy_ms": 1.5, "compute_ms": 1.0,
            "collective_ms": 0.75, "gap_ms": 0.5, "overlap_ms": 0.25,
            "measured_overlap_fraction": 0.3333, "kernel_count": 3,
            "lane_count": 1}
    gate, entered = threading.Event(), threading.Event()

    def slow(duration_ms=None):
        entered.set()
        gate.wait(timeout=10)
        return dict(fake)

    srv = server.ObservabilityServer().start()
    try:
        assert _get(srv.url + "/profilez")[0] == 404
        srv.attach_profiler(slow)
        got = []
        t = threading.Thread(target=lambda: got.append(
            _get(srv.url + "/profilez?duration_ms=5")))
        t.start()
        assert entered.wait(timeout=10)
        code, _, body = _get(srv.url + "/profilez")
        assert code == 409 and b"in flight" in body
        assert _get(srv.url + "/profilez?duration_ms=nan")[0] == 400
        gate.set()
        t.join(timeout=10)
        code, _, body = got[0]
        rec = json.loads(body)
        assert code == 200 and rec["kind"] == "profile"
        assert exporters.validate_profile_record(rec) == []
        # a window already open in the process (the real hook's check)
        from apex_tpu_torch.utils import profiler
        srv.attach_profiler(timeline.make_profiler(default_duration_ms=5))
        with profiler.profile():
            code, _, body = _get(srv.url + "/profilez")
        assert code == 409 and b"already open" in body
    finally:
        gate.set()
        srv.stop()


def test_live_scrape_of_a_running_port_fleet():
    """A port Fleet of two engines, warmed, stepping traffic on one
    thread while every endpoint is scraped from this one; /compilez lists
    the engines' census, /profilez captures a window of the traffic."""
    jm, params, tm = su.gpt(0)
    fleet = Fleet([serving.Engine(tm, slots=2, buf_len=su.BUF, window=2)
                   for _ in range(2)], policy="least_loaded", max_queue=64,
                  step_workers=1)
    fleet.warmup()
    led = compilation.get_ledger()
    t0 = led.total_traces()
    srv = server.serve(fleet=fleet, profiler=timeline.make_profiler(
        subject="fleet_window", default_duration_ms=60))
    stop, errors = threading.Event(), []

    def traffic():
        try:
            for wave in range(4):
                rids = [fleet.submit(p, max_new_tokens=6,
                                     tenant="acme" if i % 2 else "zeta")
                        for i, p in enumerate(su.prompts(wave, (3, 5, 7,
                                                                 4)))]
                while fleet.live():
                    fleet.step()
                assert all(fleet.status(r) == "finished" for r in rids)
        except Exception as e:          # noqa: BLE001
            errors.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=traffic)
    t.start()
    try:
        rounds = 0
        while True:
            for ep in server.ENDPOINTS:
                code, _, body = _get(srv.url + ep)
                assert code == 200, (ep, code, body[:200])
                if ep == "/metricsz":
                    assert exporters.validate_prometheus_text(
                        body.decode()) == []
                elif ep == "/compilez":
                    assert {"engine._prefill_slot", "engine._step_k"} <= \
                        set(json.loads(body)["entries"])
                elif ep == "/profilez":
                    rec = json.loads(body)
                    assert exporters.validate_profile_record(rec) == []
                elif ep == "/healthz":
                    assert json.loads(body)["checks"]["replicas"]["ok"]
            rounds += 1
            if stop.is_set():
                break
        t.join(timeout=60)
        assert not errors, errors
        assert rounds >= 1
        # a warmed fleet's traffic captures nothing
        assert led.total_traces() == t0
    finally:
        stop.set()
        srv.stop()


def _until(cond, timeout=10.0):
    import time
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.001)


def test_profiler_window_waits_for_the_launches_in_flight(tmp_path):
    from apex_tpu_torch.utils import profiler
    inside, go_nested, nested, release = (threading.Event()
                                          for _ in range(4))

    def launching():
        with profiler.launch_guard():
            inside.set()
            go_nested.wait(10)
            with profiler.launch_guard():    # nested: never waits
                nested.set()
            release.wait(10)

    opened, closed, late = (threading.Event() for _ in range(3))

    def window():
        with profiler.profile(str(tmp_path)):
            opened.set()
        closed.set()

    def late_launch():
        with profiler.launch_guard():
            late.set()

    a = threading.Thread(target=launching)
    a.start()
    assert inside.wait(10)
    w = threading.Thread(target=window)
    w.start()
    _until(lambda: profiler._GATE._waiting == 1)
    assert not opened.is_set() and not profiler.profiling_active()
    b = threading.Thread(target=late_launch)   # waits for the window
    b.start()
    go_nested.set()
    assert nested.wait(10)
    assert not late.wait(0.1) and not opened.is_set()
    release.set()
    for t in (a, w, b):
        t.join(timeout=30)
    assert opened.is_set() and closed.is_set() and late.is_set()
    assert os.path.exists(os.path.join(profiler.last_capture_dir(),
                                       "trace.json"))


def test_profiler_window_inside_a_launch_does_not_wait_for_itself(
        tmp_path):
    from apex_tpu_torch.utils import profiler
    with profiler.launch_guard():
        with profiler.profile(str(tmp_path)) as cap:
            with profiler.launch_guard():
                pass
    assert os.path.exists(os.path.join(cap, "trace.json"))
    assert profiler._GATE._shared == 0 and not profiler._GATE._exclusive


def test_engine_methods_hold_the_launch_guard():
    """add_request, cancel, step and warmup of every engine kind hold
    the guard: while a window opens or closes (the gate held exclusive)
    an engine's step waits."""
    from apex_tpu_torch.serving import Engine, PagedEngine, Seq2SeqEngine
    from apex_tpu_torch.utils import profiler
    for cls in (Engine, PagedEngine, Seq2SeqEngine):
        for name in ("add_request", "cancel", "step", "warmup"):
            fn = getattr(cls, name)
            assert hasattr(fn, "__wrapped__"), (cls.__name__, name)
    _, _, tm = su.gpt(0)
    eng = Engine(tm, slots=2, buf_len=su.BUF, window=2)
    stepped = threading.Event()
    t = threading.Thread(target=lambda: (eng.step(), stepped.set()))
    with profiler._GATE.exclusive():
        t.start()
        assert not stepped.wait(0.2)
    t.join(timeout=30)
    assert stepped.is_set()


def test_server_smoke_torch_gate():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "tests", "ci", "server_smoke_torch.py")
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "all 8 endpoints OK" in r.stdout
