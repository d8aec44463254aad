#!/usr/bin/env python
"""CI gate: boot the port's introspection server on an ephemeral port and
scrape it end to end — ``tests/ci/server_smoke.py`` over
``apex_tpu_torch.observability``.

Loads ``apex_tpu_torch.observability``'s server stack WITHOUT importing
the apex_tpu_torch package (its modules one by one under a stand-in
package: a smoke gate that pulls in the models, the kernels' wrappers and
the parallel stack would cost seconds per invocation for nothing), builds
a registry /
flight ring / span recorder / run supervisor with representative
content — including label values that NEED exposition escaping — then:

1. starts :class:`ObservabilityServer` on ``127.0.0.1:0``;
2. scrapes ``/healthz`` ``/metricsz`` ``/statusz`` ``/flightz``
   ``/tracez`` (and ``/tracez?trace_id=``) over real HTTP, the
   ``/profilez`` no-capture shape — with no profiler hook attached
   (the import-light deployment) the endpoint must answer 404, never
   500 — and ``/compilez`` against a compilation ledger seeded with
   a shape retrace, whose differ verdict (culprit argument) must be on
   the snapshot, and ``/tenantz`` in both deployment shapes — with no
   tenant source attached it must serve the valid empty rollup (200,
   never an error: this process has no fleet), with a seeded
   tenant source it must serve the per-tenant block, isolate a raising
   source, filter with ``?tenant=`` and 404 an unknown tenant;
3. validates ``/metricsz`` against the exposition-format conformance
   checker (``validate_prometheus_text``: TYPE/HELP lines, label
   escaping round-trip, +Inf buckets, cumulative monotonicity);
4. validates the JSON endpoints' shapes — ``/healthz`` status + check
   map, ``/statusz`` source isolation, ``/flightz`` seq-ordered events
   with exact drop accounting, ``/tracez?trace_id=`` as a schema-clean
   ``kind: trace`` record — and that the supervisor's sick verdict
   flips ``/healthz`` to 503.

Exit 0 = every scrape valid; 1 = any violation (each printed).
Wired into tier-1 by tests/test_torch_server.py (subprocess).
"""

import importlib.util
import json
import os
import sys
import urllib.error
import urllib.request

_ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), os.pardir, os.pardir))


def _load_obs():
    """Load the observability submodules the server needs, without
    importing the apex_tpu_torch package."""
    pkg_dir = os.path.join(_ROOT, "apex_tpu_torch", "observability")
    spec = importlib.util.spec_from_file_location(
        "_obs_smoke_torch", os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["_obs_smoke_torch"] = pkg
    mods = {}
    for sub in ("metrics", "exporters", "flightrec", "tracing",
                "supervisor", "compilation", "server"):
        sspec = importlib.util.spec_from_file_location(
            f"_obs_smoke_torch.{sub}", os.path.join(pkg_dir, sub + ".py"))
        mod = importlib.util.module_from_spec(sspec)
        sys.modules[f"_obs_smoke_torch.{sub}"] = mod
        sspec.loader.exec_module(mod)
        mods[sub] = mod
    return mods


def _get(url, want_status=200):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def main(argv):
    errs = []
    mods = _load_obs()
    metrics, exporters = mods["metrics"], mods["exporters"]
    flightrec, tracing = mods["flightrec"], mods["tracing"]
    supervisor, server = mods["supervisor"], mods["server"]
    compilation = mods["compilation"]

    # representative content, incl. escape-needing label values
    reg = metrics.MetricsRegistry()
    reg.counter("smoke_requests_total",
                help="requests with a \\ backslash in help").labels(
        route='/v1/"generate"\npath', shard="a\\b").inc(5)
    reg.gauge("smoke_occupancy").set(0.75)
    h = reg.histogram("smoke_latency_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 5.0):
        h.observe(v)
    ring = flightrec.EventRing(capacity=4)
    for i in range(5):                  # overflow: exact drop accounting
        ring.append("smoke_event", i=i)
    # tenant-stamped events for the ?tenant= filter: one per-request
    # stamp, one aggregate tenants list (both must match)
    ring.append("shed", queue_depth=4, max_queue=4, tenant="acme")
    ring.append("failover", replica=0, tenants=["acme", "zeta"])
    rec = tracing.SpanRecorder()
    tid = tracing.new_trace_id("smoke")
    root = rec.event("submit", trace_id=tid)
    rec.event("dispatch", trace_id=tid, parent_id=root)
    sup = supervisor.RunSupervisor("smoke_run", registry=reg, ring=ring)
    sup.observe_step(step=0, loss=1.0, step_time_s=0.01)

    # a compilation ledger with a seeded retrace: one entry
    # traced twice at different shapes, so /compilez must show the
    # differ's culprit argument (the endpoint's whole point)
    led = compilation.CompilationLedger(registry=reg, ring=ring)
    led.record_trace("engine._step_k",
                     {"ids": {"leaves": [["int32", [4, 32]]]},
                      "cur_len": {"leaves": [["int32", [4]]]}},
                     closure_id=0)
    led.record_trace("engine._step_k",
                     {"ids": {"leaves": [["int32", [4, 48]]]},
                      "cur_len": {"leaves": [["int32", [4]]]}},
                     closure_id=0)

    srv = server.ObservabilityServer(
        registry=reg, ring=ring, recorder=rec, ledger=led,
        status={"run": sup.status,
                "boom": lambda: (_ for _ in ()).throw(
                    RuntimeError("seeded source failure"))},
        health={"run": sup.health_check}).start()
    base = srv.url
    print(f"server_smoke_torch: serving on {base}")

    try:
        # /healthz — healthy run, 200 + check map
        code, ctype, body = _get(base + "/healthz")
        hz = json.loads(body)
        if code != 200 or hz.get("status") != "ok":
            errs.append(f"/healthz expected 200/ok, got {code}/"
                        f"{hz.get('status')!r}")
        if hz.get("checks", {}).get("run", {}).get("ok") is not True:
            errs.append(f"/healthz run check not ok: {hz.get('checks')}")

        # /metricsz — exposition conformance
        code, ctype, body = _get(base + "/metricsz")
        if code != 200 or not ctype.startswith("text/plain"):
            errs.append(f"/metricsz expected 200 text/plain, got "
                        f"{code} {ctype!r}")
        text = body.decode("utf-8")
        for e in exporters.validate_prometheus_text(text):
            errs.append(f"/metricsz exposition: {e}")
        fams = exporters.parse_prometheus_text(text)
        labels = fams["smoke_requests_total"]["samples"][0][1]
        if labels.get("route") != '/v1/"generate"\npath' \
                or labels.get("shard") != "a\\b":
            errs.append(f"/metricsz label escaping did not round-trip: "
                        f"{labels}")

        # /statusz — source content + error isolation
        code, _, body = _get(base + "/statusz")
        st = json.loads(body)
        if code != 200 or st.get("run", {}).get("run") != "smoke_run":
            errs.append(f"/statusz missing run source: {code}")
        if "error" not in st.get("boom", {}):
            errs.append("/statusz did not isolate the raising source")

        # /flightz — seq-ordered window, exact drop accounting
        code, _, body = _get(base + "/flightz")
        fz = json.loads(body)
        seqs = [e["seq"] for e in fz.get("events", [])]
        if code != 200 or seqs != sorted(seqs):
            errs.append(f"/flightz events not seq-ordered: {seqs}")
        if fz.get("total", 0) != fz.get("dropped", -1) + len(seqs):
            errs.append(f"/flightz drop accounting inexact: {fz}")

        # /flightz?tenant= — one tenant's story: the per-request
        # ``tenant`` stamp AND the aggregate ``tenants`` list match
        code, _, body = _get(base + "/flightz?tenant=acme")
        fzt = json.loads(body)
        kinds = sorted(e["kind"] for e in fzt.get("events", []))
        if code != 200 or kinds != ["failover", "shed"]:
            errs.append(f"/flightz?tenant=acme expected the shed + "
                        f"failover events, got {kinds}")
        code, _, body = _get(base + "/flightz?tenant=nobody")
        if json.loads(body).get("events"):
            errs.append("/flightz?tenant=nobody returned events for "
                        "an unknown tenant")

        # /tracez — index, then one schema-clean kind: trace record
        code, _, body = _get(base + "/tracez")
        tz = json.loads(body)
        if code != 200 or tid not in tz.get("traces", []):
            errs.append(f"/tracez index missing {tid}: {tz.get('traces')}")
        code, _, body = _get(base + f"/tracez?trace_id={tid}")
        trec = json.loads(body)
        for e in exporters.validate_trace_record(trec):
            errs.append(f"/tracez record: {e}")
        code, _, _ = _get(base + "/tracez?trace_id=nope")
        if code != 404:
            errs.append(f"/tracez unknown trace expected 404, got {code}")

        # /profilez — no profiler hook attached (this loader is
        # import-light by design): 404 with a JSON error, not a 500
        code, _, body = _get(base + "/profilez")
        if code != 404:
            errs.append(f"/profilez with no hook expected 404, got "
                        f"{code}")
        else:
            pz = json.loads(body)
            if "error" not in pz:
                errs.append(f"/profilez 404 body carries no error: "
                            f"{pz}")
        code, _, _ = _get(base + "/profilez?duration_ms=bogus")
        if code != 400:
            errs.append(f"/profilez with bad duration expected 400, "
                        f"got {code}")

        # /compilez — the ledger snapshot with the seeded retrace's
        # differ verdict (record_trace is pure host python)
        code, _, body = _get(base + "/compilez")
        cz = json.loads(body)
        if code != 200 or cz.get("kind") != "compilation":
            errs.append(f"/compilez expected 200 kind=compilation, "
                        f"got {code} {cz.get('kind')!r}")
        ent = cz.get("entries", {}).get("engine._step_k", {})
        if ent.get("traces") != 2 or ent.get("retraces") != 1:
            errs.append(f"/compilez entry counts wrong: {ent}")
        lr = ent.get("last_retrace") or {}
        if lr.get("cause") != "shape" or lr.get("culprit") != "ids":
            errs.append(f"/compilez last_retrace must name the shape "
                        f"culprit 'ids', got {lr}")
        if cz.get("totals", {}).get("traces") != 2:
            errs.append(f"/compilez totals wrong: {cz.get('totals')}")
        code, _, body = _get(base + "/compilez?entry=engine._step_k")
        fz1 = json.loads(body)
        if code != 200 or list(fz1.get("entries", {})) != \
                ["engine._step_k"]:
            errs.append(f"/compilez ?entry= filter broken: {code}")
        code, _, _ = _get(base + "/compilez?entry=nope")
        if code != 404:
            errs.append(f"/compilez unknown entry expected 404, got "
                        f"{code}")

        # /tenantz — no tenant source attached: the valid empty shape
        # (200, never an error — this loader is the import-light
        # deployment, exactly the process with no fleet)
        code, _, body = _get(base + "/tenantz")
        tz0 = json.loads(body)
        if (code != 200 or tz0.get("kind") != "tenants"
                or tz0.get("tenant_names") != []
                or tz0.get("class_names") != []
                or tz0.get("by_source") != {}):
            errs.append(f"/tenantz empty shape wrong: {code} {tz0}")
        code, _, _ = _get(base + "/tenantz?tenant=acme")
        if code != 404:
            errs.append(f"/tenantz?tenant= with no source expected "
                        f"404, got {code}")
        code, _, _ = _get(base + "/tenantz?class=interactive")
        if code != 404:
            errs.append(f"/tenantz?class= with no source expected "
                        f"404, got {code}")

        # /tenantz — seeded tenant source + a raising one: per-tenant
        # block served, per-source error isolation, ?tenant= filter
        bucket = {"submitted": 3, "finished": 2, "failed": 0,
                  "shed": 1, "deadline_exceeded": 0, "slo_misses": 0,
                  "goodput_tokens": 32, "with_deadline": 2,
                  "within_deadline": 2, "slo_attainment": 1.0,
                  "goodput_tokens_per_s": 12.5}
        srv.add_tenant_source("fleet", lambda: {
            "tenants": {"acme": dict(bucket), "zeta": dict(bucket)},
            "tenants_dropped": 0, "label_sets_dropped": {}})
        srv.add_tenant_source("boomfleet", lambda: (
            _ for _ in ()).throw(RuntimeError("seeded tenant source "
                                              "failure")))
        code, _, body = _get(base + "/tenantz")
        tz = json.loads(body)
        if code != 200 or tz.get("tenant_names") != ["acme", "zeta"]:
            errs.append(f"/tenantz tenant_names wrong: {code} "
                        f"{tz.get('tenant_names')}")
        acme = tz.get("by_source", {}).get("fleet", {}) \
                 .get("tenants", {}).get("acme")
        if acme != bucket:
            errs.append(f"/tenantz fleet source bucket wrong: {acme}")
        if "error" not in tz.get("by_source", {}).get("boomfleet", {}):
            errs.append("/tenantz did not isolate the raising tenant "
                        "source")
        code, _, body = _get(base + "/tenantz?tenant=acme")
        tzf = json.loads(body)
        fl_t = tzf.get("by_source", {}).get("fleet", {})
        if (code != 200 or tzf.get("filter") != "acme"
                or list(fl_t.get("tenants", {})) != ["acme"]):
            errs.append(f"/tenantz?tenant=acme filter broken: {code} "
                        f"{fl_t.get('tenants')}")
        code, _, _ = _get(base + "/tenantz?tenant=nope")
        if code != 404:
            errs.append(f"/tenantz unknown tenant expected 404, got "
                        f"{code}")

        # /tenantz?class= — a QoS-aware source adds a per-class
        # ``classes`` rollup (schema v14) next to its tenants; the
        # filter narrows it per source, 404s only when NO source
        # knows the class, and composes with ?tenant=
        cbucket = dict(bucket, preempted=1, queue_depth=0,
                       queue_cap=8, weight=8, preemptible=False)
        srv.add_tenant_source("qosfleet", lambda: {
            "tenants": {"acme": dict(bucket)},
            "classes": {"interactive": dict(cbucket),
                        "batch": dict(cbucket, weight=1,
                                      preemptible=True)},
            "tenants_dropped": 0, "preemptions": 2})
        code, _, body = _get(base + "/tenantz")
        tzc = json.loads(body)
        if (code != 200
                or tzc.get("class_names") != ["batch", "interactive"]):
            errs.append(f"/tenantz class_names wrong: {code} "
                        f"{tzc.get('class_names')}")
        code, _, body = _get(base + "/tenantz?class=interactive")
        tzc = json.loads(body)
        qf = tzc.get("by_source", {}).get("qosfleet", {})
        if (code != 200 or tzc.get("class_filter") != "interactive"
                or list(qf.get("classes", {})) != ["interactive"]
                or qf["classes"]["interactive"] != cbucket):
            errs.append(f"/tenantz?class=interactive filter broken: "
                        f"{code} {qf.get('classes')}")
        # the class filter must leave class-less sources intact (the
        # plain fleet source has no classes block) and compose with
        # the tenant filter
        code, _, body = _get(
            base + "/tenantz?tenant=acme&class=batch")
        tzb = json.loads(body)
        qf = tzb.get("by_source", {}).get("qosfleet", {})
        if (code != 200 or list(qf.get("classes", {})) != ["batch"]
                or list(qf.get("tenants", {})) != ["acme"]):
            errs.append(f"/tenantz tenant+class compose broken: "
                        f"{code} {qf}")
        code, _, body = _get(base + "/tenantz?class=nope")
        if code != 404:
            errs.append(f"/tenantz unknown class expected 404, got "
                        f"{code}")
        else:
            czerr = json.loads(body)
            if "class" not in str(czerr.get("error", "")):
                errs.append(f"/tenantz 404 body must name the class: "
                            f"{czerr}")

        # sick supervisor flips /healthz to 503
        sup.observe_step(step=1, loss=float("nan"))
        code, _, body = _get(base + "/healthz")
        hz = json.loads(body)
        if code != 503 or hz.get("status") != "unhealthy":
            errs.append(f"/healthz expected 503/unhealthy after NaN, "
                        f"got {code}/{hz.get('status')!r}")
    finally:
        srv.stop()

    for e in errs:
        print(f"server_smoke_torch: {e}", file=sys.stderr)
    if errs:
        return 1
    print("server_smoke_torch: all 8 endpoints OK (exposition conformant, "
          "schemas valid, profilez no-capture 404, compilez retrace "
          "differ verdict served, tenantz empty shape + per-tenant "
          "rollup + per-class ?class= filter + 404, sick-run 503)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
