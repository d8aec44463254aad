"""Live introspection server: scrape a running process, not its logs.

Counterpart of ``apex_tpu/observability/server.py``, copied: it serves
the existing surfaces over a stdlib ``http.server`` — no new
accounting, no new threads in any hot path, no dependencies:

- ``/healthz`` — liveness + registered health checks (JSON; HTTP 503
  when any check fails, so a fleet orchestrator can probe it directly);
- ``/metricsz`` — Prometheus text exposition of the attached
  :class:`~apex_tpu_torch.observability.MetricsRegistry`
  (``exporters.prometheus_text``, conformance-tested);
- ``/statusz`` — the attached status sources' ``stats()`` JSON
  (engine / fleet / ddp / supervisor — anything callable);
- ``/flightz`` — the :class:`~apex_tpu_torch.observability.EventRing`
  contents with the drop accounting header (``?kind=`` filters;
  ``?tenant=`` keeps only a tenant's events — both the per-request
  ones stamped ``tenant: <name>`` and the aggregate failover /
  deadline-sweep events listing the tenant in their ``tenants``);
- ``/tracez`` — :class:`~apex_tpu_torch.observability.SpanRecorder`
  records: the trace-id index by default, one schema-valid
  ``kind: trace`` record with ``?trace_id=``;
- ``/profilez`` — on-demand device-timeline capture: triggers the
  attached profiler hook (``observability.timeline.make_profiler``
  builds the standard one — a bounded ``torch.profiler`` window over the
  live process, parsed into a schema-versioned ``kind: profile``
  record).  ``?duration_ms=`` bounds the window (the hook clamps); 404
  when no profiler hook is attached (pinned by
  ``tests/ci/server_smoke_torch.py``), 409 when a capture is already in
  flight — the profiler window is a process-wide singleton, so
  concurrent captures cannot be honored;
- ``/compilez`` — the compilation-plane ledger
  (:mod:`~apex_tpu_torch.observability.compilation`): per-entry capture
  and first-call counts, the kernel build cache's hit/miss attribution,
  compile wall seconds, and each entry's last signature-change retrace
  with the differ's culprit argument.  ``?entry=`` narrows to one entry
  (404 when unknown); an empty ledger serves an empty snapshot, not an
  error;
- ``/tenantz`` — the tenant plane: every attached tenant source's
  per-tenant SLO rollup (``fleet.tenant_stats()`` — goodput,
  attainment, queue-wait vs service split, shed / deadline-miss counts
  per tenant, plus the cardinality-cap drop accounting), with the same
  per-source error isolation as ``/statusz``.  ``?tenant=`` narrows to
  one tenant and ``?class=`` narrows each source's per-QoS-class
  ``classes`` rollup to one priority class (each 404s only when NO
  source knows the name; the filters compose); a process with no tenant
  source serves the empty shape, not an error.

Attachment is one call::

    from apex_tpu_torch.observability import server
    srv = server.serve(fleet=fleet)          # ephemeral port
    print(srv.url)                            # http://127.0.0.1:PORT
    ...
    srv.stop()

``serve(engine=...)`` and ``serve(supervisor=...)`` attach the other
two first-class sources (a supervisor also registers its health check,
so ``/healthz`` turns 503 the moment the run is declared sick);
``status=`` / ``health=`` add arbitrary extra sources.  The server
runs on a daemon thread and serves every request from a fresh handler
thread (``ThreadingHTTPServer``), so a scrape can never block — and is
never blocked by — the training or serving loop.  Handlers only READ
the shared structures through their existing thread-safe snapshots.

Import-light (stdlib only at module scope):
``tests/ci/server_smoke_torch.py`` boots it without the rest of the
package.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["ObservabilityServer", "serve", "ENDPOINTS",
           "ProfileInFlight"]

ENDPOINTS = ("/healthz", "/metricsz", "/statusz", "/flightz", "/tracez",
             "/profilez", "/compilez", "/tenantz")


class ProfileInFlight(RuntimeError):
    """A profiler capture is already running in this process —
    ``/profilez`` maps it to HTTP 409 (the device profiler is a
    process-wide singleton; two overlapping captures would corrupt
    each other's windows)."""


def _json_default(obj):
    """Stats dicts may carry numpy scalars / arrays; a scrape must
    degrade to a stringy best-effort view, never 500 on a dtype."""
    for attr in ("item",):              # numpy scalars
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:           # noqa: BLE001
                break
    if hasattr(obj, "tolist"):
        try:
            return obj.tolist()
        except Exception:               # noqa: BLE001
            pass
    return repr(obj)


class ObservabilityServer:
    """Serve the process's observability surfaces over HTTP.

    ``registry`` / ``ring`` / ``recorder`` default to the process-wide
    singletons, resolved **per request** (an ``obs.set_registry`` /
    ``set_ring`` swap mid-life moves the scrape surface with it, same
    rule as every flight-recorder producer); each may also be a
    zero-arg callable returning the object (how a Fleet's per-access
    ring property is attached).

    ``status`` maps source name → zero-arg callable returning a
    JSON-able dict (``engine.stats`` / ``fleet.stats`` /
    ``supervisor.status``); a source that raises reports its error
    under its own key instead of failing the whole page.  ``health``
    maps check name → zero-arg callable returning ``(ok, detail)``;
    any failing check turns ``/healthz`` into HTTP 503.
    """

    def __init__(self, registry=None, ring=None, recorder=None,
                 status: Optional[Dict[str, Callable[[], Any]]] = None,
                 health: Optional[Dict[str, Callable[[], Tuple[bool, str]]]]
                 = None,
                 profiler: Optional[Callable] = None,
                 ledger=None,
                 tenants: Optional[Dict[str, Callable[[], Any]]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 tracez_limit: int = 512):
        self._registry = registry
        self._ring = ring
        self._recorder = recorder
        self._ledger = ledger
        self._tenants: Dict[str, Callable[[], Any]] = dict(tenants or {})
        self._status: Dict[str, Callable[[], Any]] = dict(status or {})
        self._health: Dict[str, Callable[[], Tuple[bool, str]]] = \
            dict(health or {})
        self._profiler = profiler
        self._profile_lock = threading.Lock()
        self.host = host
        self._want_port = port
        self.tracez_limit = int(tracez_limit)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()
        self._n_requests = 0
        self._req_lock = threading.Lock()

    # -- attachment surface ------------------------------------------------
    def add_status_source(self, name: str, fn: Callable[[], Any]):
        self._status[str(name)] = fn
        return self

    def add_health_check(self, name: str,
                         fn: Callable[[], Tuple[bool, str]]):
        self._health[str(name)] = fn
        return self

    def add_tenant_source(self, name: str, fn: Callable[[], Any]):
        """Attach a ``/tenantz`` source: a zero-arg callable returning
        a per-tenant rollup dict with a ``tenants`` map
        (``Fleet.tenant_stats`` is the standard one)."""
        self._tenants[str(name)] = fn
        return self

    def attach_profiler(self, fn: Callable):
        """Attach the ``/profilez`` capture hook: a callable taking one
        optional ``duration_ms`` (possibly None) and returning the
        ``kind: profile`` record body —
        ``observability.timeline.make_profiler()`` builds the standard
        one."""
        self._profiler = fn
        return self

    # -- default resolution (per request) ----------------------------------
    @staticmethod
    def _resolve(obj, default_fn):
        if obj is None:
            return default_fn()
        return obj() if callable(obj) else obj

    def registry(self):
        from .metrics import get_registry
        return self._resolve(self._registry, get_registry)

    def ring(self):
        from .flightrec import get_ring
        return self._resolve(self._ring, get_ring)

    def recorder(self):
        from .tracing import get_recorder
        return self._resolve(self._recorder, get_recorder)

    def ledger(self):
        from .compilation import get_ledger
        return self._resolve(self._ledger, get_ledger)

    # -- payload builders (also the in-process test surface) ----------------
    def healthz(self) -> Tuple[int, Dict[str, Any]]:
        """(http_status, payload): 200 when every registered check
        passes, 503 otherwise — probe-able by an orchestrator as-is."""
        checks: Dict[str, Any] = {}
        ok = True
        for name, fn in sorted(self._health.items()):
            try:
                good, detail = fn()
            except Exception as e:      # noqa: BLE001
                good, detail = False, f"health check raised: {e!r}"
            checks[name] = {"ok": bool(good), "detail": str(detail)}
            ok = ok and bool(good)
        payload = {"status": "ok" if ok else "unhealthy",
                   "uptime_s": round(time.time() - self._t0, 3),
                   "pid": os.getpid(),
                   "endpoints": list(ENDPOINTS),
                   "checks": checks}
        return (200 if ok else 503), payload

    def statusz(self) -> Dict[str, Any]:
        """Every attached source's snapshot; a raising source reports
        its error under its own key (one sick subsystem must not blank
        the page for the others — that is exactly when statusz is
        read)."""
        with self._req_lock:
            n = self._n_requests
        out: Dict[str, Any] = {"server": {
            "uptime_s": round(time.time() - self._t0, 3),
            "pid": os.getpid(), "requests": n,
            "sources": sorted(self._status)}}
        for name, fn in sorted(self._status.items()):
            try:
                out[name] = fn()
            except Exception as e:      # noqa: BLE001
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def flightz(self, kind: Optional[str] = None,
                tenant: Optional[str] = None) -> Dict[str, Any]:
        ring = self.ring()
        # ONE snapshot feeds both the events and the drop-accounting
        # header (derived from the snapshot's own seqs, the dump()
        # discipline) — a second lock acquisition for ring.stats()
        # could describe a newer ring state than the events served,
        # breaking total == dropped + retained under live appends
        events = ring.snapshot()
        if events:
            total = events[-1]["seq"] + 1
            retained = len(events)
        else:
            st = ring.stats()
            total, retained = st["total"], 0
        if kind is not None:
            events = [e for e in events if e["kind"] == kind]
        if tenant is not None:
            # per-request events carry ``tenant``; aggregate ones
            # (failover reclaim, deadline sweep, preemption) list
            # every affected tenant in ``tenants`` — one shared rule
            # (flightrec.event_matches_tenant) serves both this scrape
            # and ring.snapshot(tenant=...), so the live view and the
            # post-mortem dump can never disagree on membership
            from .flightrec import event_matches_tenant
            events = [e for e in events
                      if event_matches_tenant(e, tenant)]
        return {"kind": "flight_ring", "capacity": ring.capacity,
                "total": total, "retained": retained,
                "dropped": total - retained,
                "filter": kind, "tenant_filter": tenant,
                "events": events}

    def tracez(self, trace_id: Optional[str] = None) -> Dict[str, Any]:
        rec = self.recorder()
        if trace_id:
            from .exporters import JsonlExporter
            record = rec.trace_record(trace_id)
            if not record["spans"]:
                raise KeyError(trace_id)   # handler turns this into 404
            return JsonlExporter.enrich(record)
        ids = rec.trace_ids()
        events = rec.events()
        return {"kind": "trace_index", "traces": ids,
                "trace_count": len(ids), "event_count": len(events),
                "recent_events": events[-self.tracez_limit:]}

    def metricsz(self) -> str:
        from .exporters import prometheus_text
        return prometheus_text(self.registry())

    def compilez(self, entry: Optional[str] = None) -> Dict[str, Any]:
        """The compilation ledger's snapshot (``kind: compilation``):
        per-entry trace/retrace/compile/cache counts plus the last
        signature-change retrace's differ verdict.  ``entry=`` narrows
        the entries map to one entry; unknown raises ``KeyError``
        (handler → 404).  An empty ledger is a valid, empty snapshot —
        this endpoint stays import-light (the server_smoke deployment
        shape)."""
        snap = self.ledger().snapshot()
        if entry is not None:
            if entry not in snap["entries"]:
                raise KeyError(entry)
            snap["entries"] = {entry: snap["entries"][entry]}
            snap["filter"] = entry
        return snap

    def tenantz(self, tenant: Optional[str] = None,
                qos_class: Optional[str] = None) -> Dict[str, Any]:
        """Every attached tenant source's per-tenant SLO rollup, with
        the ``/statusz`` error-isolation rule (a raising source reports
        its error under its own key — one sick fleet must not blank the
        page).  ``tenant=`` narrows every source's ``tenants`` map to
        that tenant; ``class=`` narrows every source's ``classes`` map
        (the per-QoS-class rollup a multi-class fleet stamps
        alongside the tenants) the same way — each raises ``KeyError``
        (handler → 404) only when NO source knows the name.  The two
        filters compose.  No sources attached is the valid empty
        shape, not an error."""
        by_source: Dict[str, Any] = {}
        names: set = set()
        class_names: set = set()
        for name, fn in sorted(self._tenants.items()):
            try:
                snap = dict(fn())
            except Exception as e:      # noqa: BLE001
                by_source[name] = {"error": f"{type(e).__name__}: {e}"}
                continue
            tenants = snap.get("tenants")
            if not isinstance(tenants, dict):
                tenants = {}
            snap["tenants"] = tenants
            names.update(tenants)
            classes = snap.get("classes")
            if isinstance(classes, dict):
                class_names.update(classes)
            by_source[name] = snap
        if tenant is not None:
            if tenant not in names:
                raise KeyError(tenant)
            for snap in by_source.values():
                t = snap.get("tenants")
                if isinstance(t, dict):
                    snap["tenants"] = {k: v for k, v in t.items()
                                       if k == tenant}
        if qos_class is not None:
            if qos_class not in class_names:
                raise KeyError(qos_class)
            for snap in by_source.values():
                c = snap.get("classes")
                if isinstance(c, dict):
                    snap["classes"] = {k: v for k, v in c.items()
                                       if k == qos_class}
        return {"kind": "tenants", "filter": tenant,
                "class_filter": qos_class,
                "sources": sorted(self._tenants),
                "tenant_names": ([tenant] if tenant is not None
                                 else sorted(names)),
                "class_names": ([qos_class] if qos_class is not None
                                else sorted(class_names)),
                "by_source": by_source}

    def profilez(self, duration_ms: Optional[float] = None
                 ) -> Dict[str, Any]:
        """Trigger one bounded capture through the attached profiler
        hook and return the enriched ``kind: profile`` record.  Raises
        ``KeyError`` with no hook attached (handler → 404) and
        :class:`ProfileInFlight` when a capture is already running —
        either detected here (two concurrent ``/profilez`` scrapes) or
        raised by the hook itself (a foreign trace window is open);
        handler → 409."""
        fn = self._profiler
        if fn is None:
            raise KeyError("no profiler hook attached (serve with "
                           "profiler=timeline.make_profiler())")
        if not self._profile_lock.acquire(blocking=False):
            raise ProfileInFlight("a /profilez capture is already in "
                                  "flight")
        try:
            rec = fn(duration_ms)
        finally:
            self._profile_lock.release()
        if not isinstance(rec, dict):
            raise TypeError(f"profiler hook returned "
                            f"{type(rec).__name__}, not a record dict")
        from .exporters import JsonlExporter
        out = dict(rec)
        out.setdefault("kind", "profile")
        return JsonlExporter.enrich(out)

    # -- the HTTP plumbing --------------------------------------------------
    def _make_handler(self):
        srv = self

        class Handler(BaseHTTPRequestHandler):
            # stay quiet: scrapes every few seconds must not spam the
            # training job's stderr
            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, payload: Any):
                body = json.dumps(payload, default=_json_default
                                  ).encode("utf-8")
                self._send(code, body, "application/json")

            def do_GET(self):           # noqa: N802 (http.server API)
                with srv._req_lock:
                    srv._n_requests += 1
                parsed = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(parsed.query)
                route = parsed.path.rstrip("/") or "/"
                try:
                    if route == "/healthz":
                        code, payload = srv.healthz()
                        self._send_json(code, payload)
                    elif route == "/metricsz":
                        self._send(200, srv.metricsz().encode("utf-8"),
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif route == "/statusz":
                        self._send_json(200, srv.statusz())
                    elif route == "/flightz":
                        kind = q.get("kind", [None])[0]
                        ten = q.get("tenant", [None])[0]
                        self._send_json(200, srv.flightz(kind=kind,
                                                         tenant=ten))
                    elif route == "/tracez":
                        tid = q.get("trace_id", [None])[0]
                        try:
                            self._send_json(200, srv.tracez(trace_id=tid))
                        except KeyError:
                            self._send_json(404, {
                                "error": f"unknown trace_id {tid!r}"})
                    elif route == "/profilez":
                        raw = q.get("duration_ms", [None])[0]
                        try:
                            dur = (float(raw) if raw is not None
                                   else None)
                            # float() accepts nan/inf, which would
                            # sail through the hook's min/max clamp
                            # (NaN compares false) into time.sleep
                            if dur is not None and not (
                                    0 <= dur < float("inf")):
                                raise ValueError
                        except ValueError:
                            self._send_json(400, {
                                "error": f"duration_ms must be a "
                                         f"finite number >= 0, got "
                                         f"{raw!r}"})
                            return
                        try:
                            self._send_json(200, srv.profilez(
                                duration_ms=dur))
                        except KeyError as e:
                            self._send_json(404, {
                                "error": f"no capture available: {e}"})
                        except ProfileInFlight as e:
                            self._send_json(409, {"error": str(e)})
                    elif route == "/compilez":
                        ent = q.get("entry", [None])[0]
                        try:
                            self._send_json(200,
                                            srv.compilez(entry=ent))
                        except KeyError:
                            self._send_json(404, {
                                "error": f"unknown entry {ent!r}"})
                    elif route == "/tenantz":
                        ten = q.get("tenant", [None])[0]
                        qcls = q.get("class", [None])[0]
                        try:
                            self._send_json(200, srv.tenantz(
                                tenant=ten, qos_class=qcls))
                        except KeyError as e:
                            missing = e.args[0] if e.args else None
                            what = ("class" if qcls is not None
                                    and missing == qcls else "tenant")
                            self._send_json(404, {
                                "error": f"unknown {what} "
                                         f"{missing!r}"})
                    elif route == "/":
                        self._send_json(200, {
                            "endpoints": list(ENDPOINTS)})
                    else:
                        self._send_json(404, {
                            "error": f"unknown endpoint {route!r}",
                            "endpoints": list(ENDPOINTS)})
                except BrokenPipeError:
                    pass                # scraper went away mid-write
                except Exception as e:  # noqa: BLE001 — introspection
                    # endpoint bug must not kill the handler thread
                    # with a stack trace into the void; say what broke
                    try:
                        self._send_json(500, {
                            "error": f"{type(e).__name__}: {e}",
                            "endpoint": route})
                    except Exception:   # noqa: BLE001
                        pass

        return Handler

    def start(self) -> "ObservabilityServer":
        """Bind (ephemeral port when ``port=0``) and serve on a daemon
        thread; idempotent."""
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer((self.host, self._want_port),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="apex-tpu-torch-obs-server", daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        return (f"http://{self.host}:{self.port}"
                if self._httpd else None)

    def stop(self):
        """Shut down and join (idempotent); a stopped server can be
        ``start()``ed again on a fresh ephemeral port."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def serve(engine=None, fleet=None, supervisor=None,
          registry=None, ring=None, recorder=None,
          status: Optional[Dict[str, Callable[[], Any]]] = None,
          health: Optional[Dict[str, Callable[[], Tuple[bool, str]]]] = None,
          profiler: Optional[Callable] = None, ledger=None,
          host: str = "127.0.0.1", port: int = 0,
          start: bool = True) -> ObservabilityServer:
    """One-call attachment: build (and start) an
    :class:`ObservabilityServer` wired to an Engine, a Fleet, a
    training-run supervisor, or any combination.

    - ``engine`` → ``/statusz`` source ``engine`` (its ``stats()``) and,
      unless overridden, ``/metricsz`` serves the engine's registry;
    - ``fleet`` → source ``fleet``, the fleet's registry, the fleet's
      flight ring (per-access, so ``set_ring`` swaps follow), a
      ``replicas`` health check that fails when no replica is
      steppable, and the ``/tenantz`` tenant source
      (``fleet.tenant_stats``);
    - ``supervisor`` → source ``run`` (its ``status()``) plus its
      ``health_check`` — ``/healthz`` turns 503 the moment the run is
      declared sick.

    Explicit ``registry``/``ring``/``recorder``/``status``/``health``
    compose with (and win over) the attachment defaults.  ``profiler``
    arms ``/profilez`` (``timeline.make_profiler()`` builds the
    standard hook); without one the endpoint answers 404 — on-demand
    device captures are an explicit opt-in, never a surprise cost on a
    serving process.  ``ledger`` overrides the ``/compilez`` source
    (default: the process compilation ledger, resolved per request —
    compilation is process-wide, so engines and fleets share one).
    """
    st: Dict[str, Callable[[], Any]] = {}
    hc: Dict[str, Callable[[], Tuple[bool, str]]] = {}
    tn: Dict[str, Callable[[], Any]] = {}
    if engine is not None:
        st["engine"] = engine.stats
        if registry is None:
            registry = getattr(engine, "metrics", None)
    if fleet is not None:
        st["fleet"] = fleet.stats
        if hasattr(fleet, "tenant_stats"):
            tn["fleet"] = fleet.tenant_stats
        if registry is None:
            registry = getattr(fleet, "metrics", None)
        if ring is None:
            ring = lambda: fleet.ring      # noqa: E731 — per-access
        def _replicas_ok(fl=fleet):
            up = sum(1 for h in fl.health if h.steppable())
            if up == 0 and getattr(fl, "recovery_in_flight", False):
                # distinct degraded-but-live state: a
                # controller is mid-recovery (intentional world
                # shrink, rollback) — 503ing now would flap an
                # orchestrator into a restart loop on a fleet that is
                # already being handled
                return (True,
                        f"recovering: 0/{len(fl.replicas)} replicas "
                        f"steppable, recovery in flight")
            return (up > 0,
                    f"{up}/{len(fl.replicas)} replicas steppable")
        hc["replicas"] = _replicas_ok
    if supervisor is not None:
        st["run"] = supervisor.status
        hc["run"] = supervisor.health_check
    st.update(status or {})
    hc.update(health or {})
    srv = ObservabilityServer(registry=registry, ring=ring,
                              recorder=recorder, status=st, health=hc,
                              profiler=profiler, ledger=ledger,
                              tenants=tn, host=host, port=port)
    return srv.start() if start else srv
