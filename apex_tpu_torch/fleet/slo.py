"""SLO / goodput accounting: what the fleet delivered *in time*.

Raw throughput (``fleet_tokens_total / wall``) counts every token the
same; a serving fleet's users do not.  A token delivered after its
request's deadline bought nothing — the request already failed its SLO
— so the number that tracks user-visible capacity is **goodput**:
tokens from requests that finished within their deadline, per second
of serving.  The same per-request timeline also answers the first
triage question of any latency page: did the time go to **queue wait**
(submit → first dispatch: the fleet had no capacity) or to **service**
(dispatch → finish: the replica was slow)?

:class:`SloTracker` is fed by the fleet at the exact instants its
distributed-trace spans already record — submit, first dispatch,
finish/fail (``tracing``'s ``fleet_submit`` / ``fleet_dispatch`` /
``fleet_result`` events) — so the split it accounts and the split a
trace record shows are the same measurement; :func:`split_from_trace`
derives the latter from a ``kind: trace`` record and the tests pin the
two against each other.

Conventions:

- a request with **no deadline has no SLO**: it can neither attain nor
  miss one (it is excluded from ``slo_attainment``'s denominator), but
  its tokens still count toward goodput — they were delivered within
  every promise that was made;
- a request that **failed** (retries exhausted, rejected, deadline
  exceeded) delivers zero goodput tokens; if it carried a deadline it
  counts as an SLO miss;
- queue wait is submit → **first** dispatch: a failover's re-dispatch
  is service-side reality (the request was being served and had to be
  rescued), not queue starvation.

Registry metrics: ``fleet_queue_wait_seconds`` /
``fleet_service_seconds`` histograms, ``fleet_goodput_tokens_total`` /
``fleet_slo_miss_total`` counters, the ``fleet_slo_attainment`` and
``fleet_goodput_tokens_per_s`` gauges.  ``Fleet.stats()`` exposes the
same numbers fleet-locally under ``slo`` (plus top-level
``goodput_tokens_per_s``), and ``Fleet.record()`` carries them onto
the ``kind: fleet`` JSONL record
(``observability.exporters.validate_fleet_record`` pins the optional
fields).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..observability.metrics import (DEFAULT_MAX_LABEL_SETS,
                                     OVERFLOW_LABEL_VALUE)

__all__ = ["SloTracker", "split_from_trace"]

# sub-ms dispatch ticks up to multi-second waits under backlog
_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0, 2.5, 5.0, 10.0, 30.0)


def _new_tenant_bucket() -> Dict[str, Any]:
    # per-tenant cumulative tallies; t_first/t_last bound the tenant's
    # own goodput window the way the tracker-wide pair bounds the
    # fleet's
    return {"submitted": 0, "finished": 0, "failed": 0, "shed": 0,
            "deadline_exceeded": 0, "slo_misses": 0,
            "goodput_tokens": 0, "with_deadline": 0,
            "within_deadline": 0, "t_first": None, "t_last": None}


def _new_class_bucket() -> Dict[str, Any]:
    # per-QoS-class tallies: the tenant shape plus the preemption
    # count (only classes can be preempted — eviction direction is a
    # class-rank decision, so the tally lives here, not per tenant)
    b = _new_tenant_bucket()
    b["preempted"] = 0
    return b


class SloTracker:
    """Per-request deadline-attainment, queue-wait/service split, and
    goodput, owned and fed by one :class:`~apex_tpu_torch.fleet.Fleet`.

    All numbers are fleet-local (the registry metrics aggregate across
    fleets sharing a registry; :meth:`stats` must not — the engine-
    scheduler rule).

    Requests may carry a ``tenant`` tag (``Fleet.submit(tenant=...)``):
    every tally above is then ALSO accounted per tenant — goodput
    tokens, attainment, shed and deadline-miss counts, and
    tenant-labeled children of the registry metrics
    (``fleet_goodput_tokens_total{tenant=...}``, the queue-wait /
    service histograms).  Tenant ids are user-supplied strings, so
    distinct tenants are capped at ``max_tenants``: past the cap a new
    tenant folds into the shared ``other`` bucket and
    ``tenants_dropped`` counts the fold — the same bound (and the same
    overflow value) the metrics registry applies to label sets.
    Untagged requests stay out of the per-tenant map; their numbers
    live only in the fleet-wide tallies."""

    def __init__(self, metrics, clock,
                 max_tenants: int = DEFAULT_MAX_LABEL_SETS):
        self._clock = clock
        self.max_tenants = max_tenants
        self._m_queue_wait = metrics.histogram(
            "fleet_queue_wait_seconds",
            help="submit to first dispatch per request (fleet had no "
                 "capacity)", buckets=_WAIT_BUCKETS)
        self._m_service = metrics.histogram(
            "fleet_service_seconds",
            help="first dispatch to finish per completed request",
            buckets=_WAIT_BUCKETS)
        self._m_goodput = metrics.counter(
            "fleet_goodput_tokens_total",
            help="tokens from requests that finished within their "
                 "deadline (no-deadline requests count: no SLO was "
                 "broken)")
        self._m_miss = metrics.counter(
            "fleet_slo_miss_total",
            help="deadlined requests that failed or finished late")
        self._m_attainment = metrics.gauge(
            "fleet_slo_attainment",
            help="within-deadline fraction of resolved deadlined "
                 "requests")
        self._m_goodput_rate = metrics.gauge(
            "fleet_goodput_tokens_per_s",
            help="goodput tokens over the submit-to-last-finish window")
        # rid -> [t_submit, t_first_dispatch|None, deadline_at|None,
        #         tenant-bucket-name|None, qos-class-name|None]
        self._open: Dict[int, list] = {}
        self._with_deadline = 0         # resolved requests that had one
        self._within = 0                # ... and finished in time
        self._goodput_tokens = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._tenants: Dict[str, Dict[str, Any]] = {}
        self._tenants_dropped = 0
        # per-QoS-class tallies: class names come from the
        # fleet's QosPolicy — a small operator-declared set, so no
        # cardinality fold is needed (unlike tenant ids)
        self._classes: Dict[str, Dict[str, Any]] = {}

    # -- per-tenant plumbing ------------------------------------------------
    def _tenant_bucket(self, tenant: Optional[str]
                       ) -> Optional[Dict[str, Any]]:
        """Resolve (and lazily create) a tenant's tally bucket; past
        ``max_tenants`` distinct ids the shared overflow bucket absorbs
        the newcomer and the fold is counted — mirrors
        ``metrics._Metric.labels``."""
        if tenant is None:
            return None
        t = str(tenant)
        bucket = self._tenants.get(t)
        if bucket is None:
            if len(self._tenants) >= self.max_tenants:
                self._tenants_dropped += 1
                t = OVERFLOW_LABEL_VALUE
                bucket = self._tenants.get(t)
            if bucket is None:
                bucket = _new_tenant_bucket()
                bucket["tenant"] = t
                self._tenants[t] = bucket
        return bucket

    def tenant_name(self, tenant: Optional[str]) -> Optional[str]:
        """The bucket name a tenant id folds to (the id itself below
        the cap, ``other`` past it) — what the fleet stamps on spans,
        ring events and metric labels so every surface agrees."""
        b = self._tenant_bucket(tenant)
        return None if b is None else b["tenant"]

    def _class_bucket(self, qos_class: Optional[str]
                      ) -> Optional[Dict[str, Any]]:
        if qos_class is None:
            return None
        bucket = self._classes.get(qos_class)
        if bucket is None:
            bucket = _new_class_bucket()
            self._classes[qos_class] = bucket
        return bucket

    # -- fleet feed (same instants as the trace spans) ---------------------
    def on_submit(self, rid: int, now: float,
                  deadline_at: Optional[float],
                  tenant: Optional[str] = None,
                  qos_class: Optional[str] = None):
        b = self._tenant_bucket(tenant)
        c = self._class_bucket(qos_class)
        self._open[rid] = [now, None, deadline_at,
                           None if b is None else b["tenant"],
                           qos_class]
        if self._t_first is None:
            self._t_first = now
        if b is not None:
            b["submitted"] += 1
            if b["t_first"] is None:
                b["t_first"] = now
        if c is not None:
            c["submitted"] += 1
            if c["t_first"] is None:
                c["t_first"] = now

    def on_shed(self, tenant: Optional[str] = None,
                qos_class: Optional[str] = None) -> Optional[str]:
        """A shed happens before a rid exists, so the fleet feeds the
        tenant directly; untagged sheds live only in the fleet-wide
        counter the fleet already keeps.  Returns the folded bucket
        name (for the ring-event stamp) or None."""
        c = self._class_bucket(qos_class)
        if c is not None:
            c["shed"] += 1
        b = self._tenant_bucket(tenant)
        if b is None:
            return None
        b["shed"] += 1
        return b["tenant"]

    def on_preempt(self, qos_class: Optional[str] = None):
        """One mid-decode eviction charged to the victim's class (the
        per-class needle the runbook pairs against queue_wait: rising
        preemptions with flat queue_wait means the batch class is
        paying for interactive admission, not starving in line)."""
        c = self._class_bucket(qos_class)
        if c is not None:
            c["preempted"] += 1

    def on_dispatch(self, rid: int, now: float):
        """First dispatch only: queue wait = submit → first dispatch;
        a failover's re-dispatch is service time, not queue time."""
        rec = self._open.get(rid)
        if rec is None or rec[1] is not None:
            return
        rec[1] = now
        wait = now - rec[0]
        self._m_queue_wait.observe(wait)
        if rec[3] is not None:
            self._m_queue_wait.labels(tenant=rec[3]).observe(wait)
        if rec[4] is not None:
            self._m_queue_wait.labels(qos_class=rec[4]).observe(wait)

    def _resolve(self, rid: int, now: float):
        rec = self._open.pop(rid, None)
        if rec is None:
            return None
        self._t_last = now
        return rec

    def on_finish(self, rid: int, now: float, tokens: int):
        rec = self._resolve(rid, now)
        if rec is None:
            return
        t_submit, t_dispatch, deadline_at, tenant, qos_class = rec
        b = None if tenant is None else self._tenants.get(tenant)
        c = None if qos_class is None else self._classes.get(qos_class)
        service = now - (t_dispatch if t_dispatch is not None
                         else t_submit)
        self._m_service.observe(service)
        if tenant is not None:
            self._m_service.labels(tenant=tenant).observe(service)
        if qos_class is not None:
            self._m_service.labels(qos_class=qos_class).observe(service)
        within = deadline_at is None or now <= deadline_at
        if deadline_at is not None:
            self._with_deadline += 1
            if b is not None:
                b["with_deadline"] += 1
            if c is not None:
                c["with_deadline"] += 1
            if within:
                self._within += 1
                if b is not None:
                    b["within_deadline"] += 1
                if c is not None:
                    c["within_deadline"] += 1
            else:
                self._m_miss.inc()
                if b is not None:
                    b["slo_misses"] += 1
                    self._m_miss.labels(tenant=tenant).inc()
                if c is not None:
                    c["slo_misses"] += 1
                    self._m_miss.labels(qos_class=qos_class).inc()
        if within:
            self._goodput_tokens += int(tokens)
            self._m_goodput.inc(int(tokens))
            if b is not None:
                b["goodput_tokens"] += int(tokens)
                self._m_goodput.labels(tenant=tenant).inc(int(tokens))
            if c is not None:
                c["goodput_tokens"] += int(tokens)
                self._m_goodput.labels(
                    qos_class=qos_class).inc(int(tokens))
        if b is not None:
            b["finished"] += 1
            b["t_last"] = now
        if c is not None:
            c["finished"] += 1
            c["t_last"] = now
        self._fold_gauges()

    def on_fail(self, rid: int, now: float,
                deadline_exceeded: bool = False):
        """Failed requests (retries exhausted, rejected, deadline
        exceeded) deliver no goodput; a deadlined one is an SLO miss.
        ``deadline_exceeded`` marks the sweep-kill case so the tenant's
        miss is attributed to the deadline, not a replica fault."""
        rec = self._resolve(rid, now)
        if rec is None:
            return
        tenant, qos_class = rec[3], rec[4]
        b = None if tenant is None else self._tenants.get(tenant)
        c = None if qos_class is None else self._classes.get(qos_class)
        if rec[2] is not None:
            self._with_deadline += 1
            self._m_miss.inc()
            if b is not None:
                b["with_deadline"] += 1
                b["slo_misses"] += 1
                self._m_miss.labels(tenant=tenant).inc()
            if c is not None:
                c["with_deadline"] += 1
                c["slo_misses"] += 1
                self._m_miss.labels(qos_class=qos_class).inc()
        if b is not None:
            b["failed"] += 1
            if deadline_exceeded:
                b["deadline_exceeded"] += 1
            b["t_last"] = now
        if c is not None:
            c["failed"] += 1
            if deadline_exceeded:
                c["deadline_exceeded"] += 1
            c["t_last"] = now
        self._fold_gauges()

    # -- aggregates ---------------------------------------------------------
    @property
    def slo_attainment(self) -> Optional[float]:
        """Within-deadline fraction over resolved deadlined requests;
        None while no deadlined request has resolved (an attainment of
        a promise nobody made would read as a perfect score)."""
        if self._with_deadline == 0:
            return None
        return self._within / self._with_deadline

    def goodput_tokens_per_s(self,
                             now: Optional[float] = None) -> float:
        """Goodput tokens over the first-submit → last-finish window
        (``now`` extends the window for a still-running fleet)."""
        if self._t_first is None:
            return 0.0
        ends = [t for t in (self._t_last, now) if t is not None]
        if not ends:
            return 0.0                   # nothing resolved yet
        dt = max(ends) - self._t_first
        return self._goodput_tokens / dt if dt > 0 else 0.0

    @staticmethod
    def _tenant_attainment(b: Dict[str, Any]) -> Optional[float]:
        if b["with_deadline"] == 0:
            return None
        return b["within_deadline"] / b["with_deadline"]

    @staticmethod
    def _tenant_rate(b: Dict[str, Any],
                     now: Optional[float] = None) -> float:
        if b["t_first"] is None:
            return 0.0
        ends = [t for t in (b["t_last"], now) if t is not None]
        if not ends:
            return 0.0
        dt = max(ends) - b["t_first"]
        return b["goodput_tokens"] / dt if dt > 0 else 0.0

    def _fold_gauges(self):
        att = self.slo_attainment
        if att is not None:
            self._m_attainment.set(att)
        self._m_goodput_rate.set(self.goodput_tokens_per_s())
        for t, b in self._tenants.items():
            ta = self._tenant_attainment(b)
            if ta is not None:
                self._m_attainment.labels(tenant=t).set(ta)
            self._m_goodput_rate.labels(tenant=t).set(
                self._tenant_rate(b))
        for cname, c in self._classes.items():
            ca = self._tenant_attainment(c)
            if ca is not None:
                self._m_attainment.labels(qos_class=cname).set(ca)
            self._m_goodput_rate.labels(qos_class=cname).set(
                self._tenant_rate(c))

    @property
    def tenants_dropped(self) -> int:
        """Fold events: submissions/sheds whose over-cap tenant id was
        absorbed by the ``other`` bucket (mirrors the per-call
        semantics of ``metrics._Metric.labels_dropped``)."""
        return self._tenants_dropped

    def tenant_stats(self, now: Optional[float] = None
                     ) -> Dict[str, Dict[str, Any]]:
        """Per-tenant rollup: the tally bucket plus derived attainment
        / goodput rate and the tenant-labeled queue-wait / service
        summaries (labeled children of the registry histograms — the
        one per-tenant number that is registry- rather than
        fleet-scoped when fleets share a registry)."""
        out: Dict[str, Dict[str, Any]] = {}
        for t, b in sorted(self._tenants.items()):
            entry = {k: v for k, v in b.items()
                     if k not in ("t_first", "t_last", "tenant")}
            entry["slo_attainment"] = self._tenant_attainment(b)
            entry["goodput_tokens_per_s"] = round(
                self._tenant_rate(b, now=now), 4)
            entry["queue_wait"] = self._m_queue_wait.labels(
                tenant=t).summary()
            entry["service_time"] = self._m_service.labels(
                tenant=t).summary()
            out[t] = entry
        return out

    @staticmethod
    def zero_class_stats() -> Dict[str, Any]:
        """The derived-stats shape of a class that saw no traffic —
        what ``Fleet._class_block`` emits for a policy class before
        its first request (so dashboards keyed on a class never 404)."""
        entry = {k: v for k, v in _new_class_bucket().items()
                 if k not in ("t_first", "t_last")}
        entry["slo_attainment"] = None
        entry["goodput_tokens_per_s"] = 0.0
        return entry

    def class_stats(self, now: Optional[float] = None
                    ) -> Dict[str, Dict[str, Any]]:
        """Per-QoS-class rollup, shaped like :meth:`tenant_stats`
        (same derived attainment/rate, same labeled histogram
        summaries) plus the per-class ``preempted`` count."""
        out: Dict[str, Dict[str, Any]] = {}
        for cname, c in sorted(self._classes.items()):
            entry = {k: v for k, v in c.items()
                     if k not in ("t_first", "t_last")}
            entry["slo_attainment"] = self._tenant_attainment(c)
            entry["goodput_tokens_per_s"] = round(
                self._tenant_rate(c, now=now), 4)
            entry["queue_wait"] = self._m_queue_wait.labels(
                qos_class=cname).summary()
            entry["service_time"] = self._m_service.labels(
                qos_class=cname).summary()
            out[cname] = entry
        return out

    def stats(self, now: Optional[float] = None) -> Dict[str, Any]:
        """``now`` extends the goodput window for a still-running
        fleet (``Fleet.stats()`` passes its clock while work is live,
        so every goodput figure in one snapshot uses ONE window)."""
        return {
            "with_deadline": self._with_deadline,
            "within_deadline": self._within,
            "slo_attainment": self.slo_attainment,
            "goodput_tokens": self._goodput_tokens,
            "goodput_tokens_per_s": round(
                self.goodput_tokens_per_s(now=now), 4),
            "queue_wait": self._m_queue_wait.summary(),
            "service_time": self._m_service.summary(),
            "tenants": self.tenant_stats(now=now),
            "tenants_dropped": self._tenants_dropped,
            "classes": self.class_stats(now=now),
        }


def split_from_trace(trace_record: Dict[str, Any]
                     ) -> Optional[Dict[str, float]]:
    """Queue-wait / service split of ONE request derived from its
    ``kind: trace`` record (the spans ``Fleet`` already emits):
    ``fleet_submit`` → first ``fleet_dispatch`` is queue wait,
    first dispatch → ``fleet_result``/``fleet_failed`` is service.
    Returns ``{queue_wait_s, service_s, total_s}`` (seconds; span
    timestamps are µs) or None when the record lacks the needed hops
    — the cross-check that pins :class:`SloTracker`'s accounting to
    the trace timeline."""
    t_submit = t_dispatch = t_end = None
    for sp in trace_record.get("spans", ()):
        name, ts = sp.get("name"), sp.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        if name == "fleet_submit" and t_submit is None:
            t_submit = ts
        elif name == "fleet_dispatch" and t_dispatch is None:
            t_dispatch = ts
        elif name in ("fleet_result", "fleet_failed"):
            t_end = ts                   # last one wins
    if t_submit is None or t_end is None:
        return None
    anchor = t_dispatch if t_dispatch is not None else t_end
    return {"queue_wait_s": max(anchor - t_submit, 0.0) / 1e6,
            "service_s": max(t_end - anchor, 0.0) / 1e6,
            "total_s": max(t_end - t_submit, 0.0) / 1e6}
