"""The fleet: N serving replicas behind one submit/step/result API.

Counterpart of ``apex_tpu/fleet/fleet.py``, its control logic copied.
The replicas are the port's engines (``serving.Engine``,
``PagedEngine``, ``Seq2SeqEngine``) or anything with their scheduler
surface.  On the card an engine's admissions and decode windows are
CUDA graphs; a replica whose step may still capture one is stepped
alone on the fleet thread, never beside a pool worker (``step``).

``Fleet`` owns the request lifecycle end to end:

- ``submit`` validates nothing about shapes (replicas do that at
  dispatch) but enforces BACKPRESSURE: the fleet queue is bounded, and
  a full queue raises :class:`router.FleetOverloaded` instead of
  growing without bound — the explicit shed the single engine's
  ``_waiting`` list never had.
- ``step()`` is one cooperative fleet tick: breaker cooldowns advance,
  deadlines are enforced, queued requests dispatch through the routing
  policy onto admissible replicas (free slot, or a short per-replica
  queue of depth ``replica_queue_cap`` so engines can admit at their
  own window boundaries), every steppable replica takes one ``step()``
  with latency + errors feeding its :class:`health.ReplicaHealth`,
  finishes are harvested, and a replica whose dispatch raised — or
  that sat silent on live work past the stall watchdog — FAILS OVER:
  its in-flight and queued requests are reclaimed (best-effort
  cancelled on the sick replica) and restarted from their prompts on
  survivors.
- ``result`` returns the request's final tokens from the replica that
  actually finished it.  Because a failed-over request restarts from
  its prompt and greedy / explicitly-seeded sampled decodes are
  request-intrinsic, those final tokens are token-for-token what an
  undisturbed single engine produces (pinned in
  tests/test_torch_fleet.py).
  ``step()``'s incremental emissions, by contrast, are at-least-once
  across a failover (the restart re-emits from the beginning) —
  consume ``result()`` for exactness, emissions for liveness.

Drain (rolling restart): ``drain(i)`` stops admission, re-enqueues the
replica's waiting queue onto the fleet (→ survivors), and keeps
stepping its in-flight requests until they finish, at which point the
replica parks as ``drained``; ``undrain(i)`` re-enlists it.

Failure is bounded: each dispatch failure or failover consumes one of
``RetryPolicy.max_attempts`` attempts (with exponential-backoff
step delays between dispatch retries), after which — or after a
per-request ``deadline`` passes — the request lands in ``result()`` as
a raised ``RuntimeError`` instead of spinning forever.

Telemetry: a fleet-level :class:`~apex_tpu_torch.observability.MetricsRegistry`
carries ``fleet_retries_total`` / ``fleet_shed_total`` /
``fleet_failover_total`` / ``fleet_drains_total`` (and friends) plus
per-replica labeled gauges; ``stats()`` aggregates the replicas'
own ``stats()``; ``record()`` is the ``kind: fleet`` JSONL record
``observability.exporters.validate_fleet_record`` pins.

Flight recorder: every submitted request gets a distributed
trace ("<fleet_trace>/r<rid>") whose lifecycle events — submit, route,
dispatch, fault, reclaim, result — chain causally on the process
:class:`~apex_tpu_torch.observability.SpanRecorder`, with engine-internal
spans (queue/prefill/window-decode) parenting under the dispatch hop
even across the step pool's worker threads; rare operational
transitions (failover/shed/retry/deadline/stall, plus the breaker
moves ``health.ReplicaHealth`` notes and the faults ``faults.
FaultyReplica`` injects) land in a bounded
:class:`~apex_tpu_torch.observability.EventRing`, dumped to
``flight_dump_path`` the moment a replica fails.
"""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..observability import MetricsRegistry, flightrec, tracing
from .health import (DEAD, DEGRADED, DRAINED, DRAINING, HEALTHY,
                     STATE_CODES, HealthConfig, ReplicaHealth)
from .qos import QosPolicy, WfqQueue
from .router import FleetOverloaded, RetryPolicy, make_policy
from .slo import SloTracker

__all__ = ["Fleet"]


def _may_capture(rep) -> bool:
    """Whether ``rep.step()`` may capture a CUDA graph: the port's
    engines name the graphs they have not captured yet
    (``uncaptured()``); a replica without the method (a stub, a remote
    proxy) captures nothing."""
    fn = getattr(rep, "uncaptured", None)
    return bool(fn()) if callable(fn) else False


class _FleetRequest:
    def __init__(self, rid, prompt, max_new, eos, seed, temperature,
                 deadline_at, tenant=None, priority=None,
                 qos_class=None):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new = max_new
        self.eos = eos
        self.seed = seed
        self.temperature = temperature
        self.deadline_at = deadline_at      # absolute clock time or None
        # tenant is the FOLDED bucket name (SloTracker.tenant_name):
        # every surface that stamps it — spans, ring events, metric
        # labels, per-tenant stats — agrees on the same string even
        # past the cardinality cap
        self.tenant = tenant
        self.priority = priority
        # resolved priority class (QosPolicy.resolve at submit): the
        # WfqQueue keys its per-class FIFOs on this, and preemption
        # direction compares class RANKS, never the raw priority tag
        self.qos_class = qos_class
        self.preemptions = 0                # times evicted mid-decode
        self.assigned: Optional[Tuple[int, int]] = None  # (replica, rrid)
        self.attempts = 0                   # failed dispatches + failovers
        self.next_attempt_step = 0
        self.restarts = 0
        self.generated: List[int] = []
        self.error: Optional[str] = None
        self.t_submit: Optional[float] = None
        self.t_finish: Optional[float] = None
        # distributed-trace spine: trace_id is minted at submit
        # ("<fleet_trace>/r<rid>"); last_span is the causal tail every
        # later lifecycle event parents on.  Both are touched ONLY on
        # the fleet thread (submit/dispatch/harvest/failover), so the
        # chain cannot interleave no matter how the step pool schedules
        self.trace_id: Optional[str] = None
        self.last_span: Optional[int] = None


class Fleet:
    """Front ``replicas`` (Engine / Seq2SeqEngine / FaultyReplica —
    anything with the scheduler surface) behind one API.

    ``policy`` is a name (``"round_robin"`` / ``"least_loaded"`` /
    ``"prefix_affinity"``) or an instance; ``max_queue`` bounds the
    fleet queue (full = shed); ``replica_queue_cap`` bounds how much
    the fleet will queue ON a replica beyond its free slots (0 = admit
    only into free slots); ``retry`` and ``health`` take
    :class:`router.RetryPolicy` / :class:`health.HealthConfig`;
    ``clock`` is injectable for deterministic deadline tests."""

    def __init__(self, replicas: Sequence[Any],
                 policy="least_loaded",
                 max_queue: int = 64,
                 replica_queue_cap: int = 2,
                 retry: Optional[RetryPolicy] = None,
                 health: Optional[HealthConfig] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 clock=None,
                 step_workers: Optional[int] = None,
                 ring=None,
                 trace: bool = True,
                 flight_dump_path: Optional[str] = None,
                 qos: Optional[QosPolicy] = None):
        if not replicas:
            raise ValueError("Fleet needs at least one replica")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if replica_queue_cap < 0:
            raise ValueError(f"replica_queue_cap must be >= 0, got "
                             f"{replica_queue_cap}")
        self.replicas = list(replicas)
        self.policy = make_policy(policy)
        self.max_queue = max_queue
        self.replica_queue_cap = replica_queue_cap
        self.retry = retry or RetryPolicy()
        self.health_config = health or HealthConfig()
        # flight recorder + distributed tracing: the ring holds the
        # rare operational transitions (failover/shed/retry/deadline/
        # stall + the breaker transitions ReplicaHealth notes); with
        # ``trace=True`` every submitted request gets a trace context
        # ("<fleet_trace>/r<rid>") whose lifecycle events land on the
        # process SpanRecorder.  ``flight_dump_path`` dumps the ring
        # there the moment a replica fails — the post-mortem artifact.
        # explicit ring binds here; None resolves the PROCESS ring
        # lazily at every append (via the `ring` property), so an
        # operator swapping obs.set_ring() mid-life moves this fleet's
        # whole story — failover/breaker/shed/fault AND record_scaler's
        # skips — to the new ring together instead of splitting it
        self._ring = ring
        self.tracing = bool(trace)
        self.flight_dump_path = flight_dump_path
        self.trace_id = tracing.new_trace_id("fleet")
        self.health = [ReplicaHealth(self.health_config,
                                     ring=ring,
                                     name=i)
                       for i in range(len(self.replicas))]
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._clock = clock if clock is not None else time.perf_counter
        # replica step() dispatches can overlap across a thread pool:
        # torch releases the GIL in a CUDA-graph replay and while the
        # window's host read waits for the card, so one replica's
        # Python (harvest, admission) runs while another's window runs
        # on the device.  Replicas on one card share its SMs: their
        # windows do not run faster side by side, what overlaps is one
        # replica's host work with another's device work.  A graph
        # capture must meet no other thread's CUDA work, so a replica
        # whose step may capture (``uncaptured()`` names a graph) is
        # stepped alone on the fleet thread (see ``step``).  Results
        # are identical either way (replicas never share mutable
        # state); the default only goes parallel when the host has
        # cores to spare: on a small shared-CPU host threading
        # replicas oversubscribes its cores, so serial is the floor,
        # not a fallback.
        if step_workers is None:
            step_workers = max(1, min(len(self.replicas),
                                      (os.cpu_count() or 2) // 2))
        if step_workers < 1:
            raise ValueError(f"step_workers must be >= 1, got "
                             f"{step_workers}")
        self.step_workers = step_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        # QoS plane: the pending queue is a WfqQueue — under
        # the default single-class policy its order IS submission
        # order (exact FIFO), so a policy-less fleet behaves
        # byte-for-byte as before; with a multi-class policy it
        # stride-schedules across per-class FIFOs.  ``_qos_active``
        # gates the class stamp on spans/events so untagged fleets
        # keep their pre-QoS event shapes.
        self.qos = qos if qos is not None else QosPolicy.single()
        self._qos_active = len(self.qos.classes) > 1
        self._pending: WfqQueue = WfqQueue(self.qos)
        self._inflight: Dict[Tuple[int, int], _FleetRequest] = {}
        self._results: Dict[int, _FleetRequest] = {}
        # rid -> trace id, retained for the fleet's lifetime like
        # _results (one short string per request); the span events
        # themselves live on the BOUNDED process recorder, so an old
        # request's trace eventually evicts oldest-first
        self._trace_ids: Dict[int, str] = {}
        self._next_rid = 0
        self._step_no = 0
        self._idle_steps = [0] * len(self.replicas)
        self._prefix_map: Dict[tuple, int] = {}
        # fleet-LOCAL totals (registry counters aggregate across fleets
        # sharing a registry; stats() must not — same rule as the
        # engine scheduler)
        self._n_submitted = 0
        self._n_finished = 0
        self._n_failed = 0
        self._n_tokens = 0
        self._n_shed = 0
        # overload episodes are PER CLASS: an admitted interactive
        # request must not end the batch class's shed episode (with
        # the default single class this degenerates to the old global
        # flag — any admit ends the episode)
        self._shedding_classes: set = set()
        self._tick_retry_logged: set = set()  # replicas ring-logged this tick
        self._n_retries = 0
        self._n_failovers = 0
        self._n_drains = 0
        self._n_deadline = 0
        self._n_preempted = 0
        # MTTR accounting: a failover opens a recovery window;
        # the first subsequent tick with real progress (tokens emitted
        # or a finish harvested) closes it — fault injection to first
        # post-recovery step, the fleet-side number bench --chaos
        # trends.  ``recovery_in_flight`` is the controllers' flag
        # (SloController / an operator mid-world-shrink): while set,
        # the introspection server's no-steppable-replica check
        # reports the distinct degraded-but-live "recovering" state
        # instead of 503ing an orchestrator into a restart loop.
        self._recover_t0: Optional[float] = None
        self._recovering_rids: set = set()
        self._recovering_tenants: set = set()
        self._recovered_tick = False    # reclaimed work progressed now
        self._mttr_last: Optional[float] = None
        self._mttr_sum = 0.0
        self._mttr_count = 0
        self.recovery_in_flight = False
        # the most recent deadline sweep's aggregate (count + first
        # rids), previously visible only on the flight ring — exposed
        # through stats()/record() so a dashboard need not tail the
        # ring to see WHAT just expired
        self._last_deadline_sweep: Dict[str, Any] = {
            "count": 0, "rids": [], "fleet_step": None}
        m = self.metrics
        # SLO/goodput accounting, fed at the same instants the trace
        # spans record (submit / first dispatch / finish / fail)
        self.slo = SloTracker(m, self._clock)
        self._m_submitted = m.counter("fleet_submitted_total")
        self._m_finished = m.counter("fleet_finished_total")
        self._m_failed = m.counter(
            "fleet_failed_total",
            help="requests failed after retry exhaustion or deadline")
        self._m_tokens = m.counter("fleet_tokens_total")
        self._m_retries = m.counter(
            "fleet_retries_total",
            help="dispatch attempts that failed and were retried")
        self._m_shed = m.counter(
            "fleet_shed_total",
            help="submissions refused with FleetOverloaded (bounded "
                 "queue full)")
        self._m_failover = m.counter(
            "fleet_failover_total",
            help="requests reclaimed from a sick replica and "
                 "restarted on a survivor")
        self._m_drains = m.counter("fleet_drains_total")
        self._m_deadline = m.counter("fleet_deadline_exceeded_total")
        self._m_preempted = m.counter(
            "fleet_preemptions_total",
            help="in-flight requests evicted mid-decode to admit a "
                 "higher-priority class (re-queued from their prompt)")
        self._m_latency = m.histogram(
            "fleet_request_seconds",
            help="submit-to-finish latency per completed request")
        m.gauge("fleet_replicas").set(float(len(self.replicas)))

    @property
    def ring(self):
        """The flight ring this fleet appends to: the one passed at
        construction, else the CURRENT process ring (resolved per
        access, so ``obs.set_ring`` swaps mid-life take effect)."""
        return flightrec.resolve(self._ring)

    # -- submission --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               seed: Optional[int] = None,
               temperature: Optional[float] = None,
               deadline: Optional[float] = None,
               tenant: Optional[str] = None,
               priority: Optional[int] = None) -> int:
        """Queue a request; returns the fleet request id.  Raises
        :class:`FleetOverloaded` (retriable) when the bounded fleet
        queue is full.  ``deadline`` is seconds from now: a request
        not finished in time fails with a deadline error instead of
        occupying capacity forever.

        ``tenant`` tags the request for per-tenant accounting: SLO /
        goodput tallies, tenant-labeled registry metrics, and the
        tenant stamp on every trace span and ring event the request
        touches (shed / deadline / failover events say WHOSE request
        suffered).  Tenant ids are user-supplied strings — past the
        tracker's cardinality cap new ids fold into the shared
        ``other`` bucket.  ``priority`` is CONSUMED by the QoS plane:
        it resolves to a priority class via the fleet's
        :class:`~apex_tpu_torch.fleet.qos.QosPolicy` (explicit priority
        naming a known class wins, then the tenant->class map, then
        the default class), which decides the request's weighted-fair
        dispatch share, its per-class queue quota, its default
        deadline, and whether it may be preempted mid-decode."""
        qcls = self.qos.resolve(tenant, priority)
        # shed against BOTH bounds: the global queue AND the class's
        # own quota (queue_share x max_queue) — a batch flood sheds
        # against its quota long before it can squeeze the
        # interactive class out of the queue
        cap = self.qos.cap(qcls, self.max_queue)
        if (len(self._pending) >= self.max_queue
                or self._pending.depth(qcls) >= cap):
            self._n_shed += 1
            self._m_shed.inc()
            # a shed happens before a rid exists; feed the tenant
            # straight to the tracker (folded name comes back for the
            # ring stamp)
            shed_tenant = self.slo.on_shed(
                tenant, qos_class=qcls if self._qos_active else None)
            if qcls not in self._shedding_classes:
                # one ring event per overload EPISODE (the transition
                # into shedding), not per rejected submit: sustained
                # overload is hundreds of rejections a second, which
                # would wheel the bounded ring past the breaker/
                # failover history a post-mortem needs.
                # fleet_shed_total carries the volume.
                self._shedding_classes.add(qcls)
                self.ring.append("shed",
                                 queue_depth=len(self._pending),
                                 max_queue=self.max_queue,
                                 **({"qos_class": qcls}
                                    if self._qos_active else {}),
                                 **({"tenant": shed_tenant}
                                    if shed_tenant is not None else {}))
            raise FleetOverloaded(len(self._pending), self.max_queue,
                                  qos_class=(qcls if self._qos_active
                                             else None))
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0 seconds, got "
                             f"{deadline}")
        if deadline is None:
            # per-class default deadline (validated > 0 at policy
            # construction) — interactive classes get their SLO bound
            # without every caller restating it
            deadline = self.qos.deadline_for(qcls)
        rid = self._next_rid
        self._next_rid += 1
        now = self._clock()
        req = _FleetRequest(rid, prompt, max_new_tokens, eos_token_id,
                            seed, temperature,
                            None if deadline is None else now + deadline,
                            tenant=self.slo.tenant_name(tenant),
                            priority=priority,
                            qos_class=qcls)
        req.t_submit = now
        if self.tracing:
            # the root of the request's causal chain; every later
            # lifecycle event (route/dispatch/fault/reclaim/result)
            # parents on the chain's tail
            req.trace_id = f"{self.trace_id}/r{rid}"
            self._trace_ids[rid] = req.trace_id
            req.last_span = tracing.get_recorder().event(
                "fleet_submit", trace_id=req.trace_id, rid=rid,
                prompt_len=len(req.prompt), max_new=max_new_tokens,
                queue_depth=len(self._pending),
                **self._tenant_attrs(req))
        self._pending.append(req)
        # an admitted submit ends THIS class's overload episode
        self._shedding_classes.discard(qcls)
        self._n_submitted += 1
        self._m_submitted.inc()
        # feed the ALREADY-folded name (req.tenant): folding twice
        # would double-count tenants_dropped for over-cap ids
        self.slo.on_submit(rid, now, req.deadline_at,
                           tenant=req.tenant,
                           qos_class=qcls if self._qos_active else None)
        return rid

    def _tenant_attrs(self, req: "_FleetRequest") -> Dict[str, Any]:
        """The tenant/priority/class stamp for spans and ring events;
        empty for untagged requests under the default policy so their
        events keep the pre-tenant shape.  With a multi-class policy
        EVERY request carries its resolved class (untagged traffic
        lands in the default class — the class split must cover 100%
        of traffic or the /tenantz class view lies)."""
        attrs: Dict[str, Any] = {}
        if req.tenant is not None:
            attrs["tenant"] = req.tenant
        if req.priority is not None:
            attrs["priority"] = req.priority
        if self._qos_active and req.qos_class is not None:
            attrs["qos_class"] = req.qos_class
        return attrs

    def _trace_ev(self, req: "_FleetRequest", name: str,
                  **attrs) -> Optional[int]:
        """Append one lifecycle event to the request's trace, chaining
        it on the previous tail; fleet-thread only.  Tagged requests
        carry their tenant/priority on EVERY hop — including the
        fault/reclaim/re-dispatch chain across a failover."""
        if not (self.tracing and req.trace_id):
            return None
        req.last_span = tracing.get_recorder().event(
            name, trace_id=req.trace_id, parent_id=req.last_span,
            rid=req.rid, **{**self._tenant_attrs(req), **attrs})
        return req.last_span

    def register_prefix(self, tokens: Sequence[int],
                        replica: Optional[int] = None) -> int:
        """Prefill ``tokens`` into ONE replica's prefix pool and
        remember the owner: with the ``prefix_affinity`` policy, later
        prompts starting with these tokens route there (KV-splice
        admission).  Returns the owning replica index."""
        if replica is None:
            cands = [i for i in range(len(self.replicas))
                     if self.health[i].admissible()]
            if not cands:
                raise RuntimeError("no admissible replica to own the "
                                   "prefix")
            replica = min(cands, key=lambda i: (
                self.replicas[i].stats()["occupancy"], i))
        self.replicas[replica].register_prefix(tokens)
        self._prefix_map[tuple(int(t) for t in tokens)] = replica
        return replica

    def warmup(self) -> "Fleet":
        """Capture EVERY replica's admission and decode graphs before
        traffic (each replica's ``warmup()``).  Each ``Engine`` instance
        captures its own graphs, so a cold N-replica fleet would pay N
        captures spread across its first timed windows.  After
        ``warmup()`` steady-state traffic AND a failover restarting
        reclaimed requests on survivors capture nothing more: each
        replica's ``captures`` stays as it is (pinned in
        tests/test_torch_cuda.py).  Replicas without a
        ``warmup`` method (stubs, remote proxies) are skipped; a
        fault-harness wrapper delegates to its inner engine without
        advancing its fault windows.  Returns ``self``."""
        for rep in self.replicas:
            fn = getattr(rep, "warmup", None)
            if callable(fn):
                fn()
        self.ring.append("fleet_warmup",
                         replicas=len(self.replicas))
        return self

    def prefix_owner(self, prompt: Sequence[int]) -> Optional[int]:
        """Replica owning the longest registered prefix of ``prompt``,
        or None."""
        pt = tuple(int(t) for t in prompt)
        best, best_len = None, 0
        for pref, owner in self._prefix_map.items():
            if len(pref) > best_len and pt[:len(pref)] == pref:
                best, best_len = owner, len(pref)
        return best

    # -- the fleet tick ----------------------------------------------------
    def step(self) -> Dict[int, List[int]]:
        """One cooperative tick over every replica; returns
        ``{fleet_rid: [tokens]}`` emitted this tick.  Emissions are
        at-least-once across failovers (a restarted request re-emits
        from its first token); ``result()`` is the exactly-once
        surface."""
        self._step_no += 1
        self._tick_retry_logged.clear()
        self._recovered_tick = False
        for h in self.health:
            h.tick()
        self._check_deadlines()
        self._dispatch()
        out: Dict[int, List[int]] = {}
        plan = []
        for i, rep in enumerate(self.replicas):
            mine = [k for k in self._inflight if k[0] == i]
            if self.health[i].steppable() and (mine
                                               or rep.live() > 0):
                plan.append((i, rep, mine))

        def dispatch(item):
            # runs on a pool worker: the span carries the FLEET-run
            # trace and is this thread's ambient parent, so
            # engine-internal spans (window decode) nest under the
            # right replica's dispatch even with step_workers > 1 —
            # pool threads get their own contextvar context and the
            # span resets it on exit, so reused workers never inherit
            # a stale parent
            i, rep, _ = item
            t0 = self._clock()
            cm = (tracing.get_recorder().span(
                      "fleet_replica_step", trace_id=self.trace_id,
                      replica=i, fleet_step=self._step_no)
                  if self.tracing else contextlib.nullcontext())
            try:
                with cm:
                    out = rep.step()
                return i, out, self._clock() - t0, None
            except Exception as e:  # noqa: BLE001 — any replica death
                return i, None, self._clock() - t0, e

        # a replica that may capture a CUDA graph in this step never
        # shares the card with a pool worker: the pool steps the others
        # first, then it steps alone on this thread (a capture meeting
        # another thread's launch, allocation or host read breaks)
        pooled = [item for item in plan if not _may_capture(item[1])]
        if self.step_workers > 1 and len(pooled) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.step_workers,
                    thread_name_prefix="fleet-step")
            done = dict(zip((item[0] for item in pooled),
                            self._pool.map(dispatch, pooled)))
            stepped = [done[item[0]] if item[0] in done
                       else dispatch(item) for item in plan]
        else:
            stepped = [dispatch(item) for item in plan]

        # post-processing stays on the fleet thread, in replica order —
        # health, failover and harvest are deterministic regardless of
        # how the pool interleaved the dispatches
        for (i, rep, mine), (_, emitted, dt, exc) in zip(plan, stepped):
            h = self.health[i]
            if exc is not None:
                self._replica_failed(i, f"step raised: {exc}")
                continue
            if mine:
                h.record_success(dt)
            progressed = False
            for rrid, toks in emitted.items():
                req = self._inflight.get((i, rrid))
                if req is None:        # stale pre-failover slot: drop
                    continue
                if toks:
                    progressed = True
                    out.setdefault(req.rid, []).extend(int(t)
                                                       for t in toks)
            for key in mine:
                req = self._inflight.get(key)
                if req is None:
                    continue
                try:
                    done = rep.is_finished(key[1])
                except Exception:
                    done = False
                if done:
                    progressed = True
                    del self._inflight[key]
                    self._finish(req, rep.result(key[1]))
            # no-progress watchdog: live fleet work, zero tokens, zero
            # finishes — a stall or result-dropper that never raises
            if mine and not progressed:
                self._idle_steps[i] += 1
                if self._idle_steps[i] >= self.health_config.stall_steps:
                    self._idle_steps[i] = 0
                    self.ring.append("stall_watchdog", replica=i,
                                     stall_steps=self.health_config
                                     .stall_steps)
                    self._replica_failed(
                        i, f"no progress for "
                           f"{self.health_config.stall_steps} steps "
                           f"(stall watchdog)")
            else:
                self._idle_steps[i] = 0
        for i, h in enumerate(self.health):
            if h.draining and not any(k[0] == i for k in self._inflight):
                h.finish_drain()
        if self._recover_t0 is not None:
            # close the MTTR window at the first tick where reclaimed
            # work makes progress again — a restarted request emits or
            # finishes on a survivor (_finish sets the tick flag
            # before dropping the rid from the watch set).  Windows
            # with nothing left to rescue were already abandoned
            # without an MTTR sample (see _abandon_recovery), so they
            # can never span unrelated idle time.
            recovered = (self._recovered_tick
                         or bool(self._recovering_rids & set(out)))
            if recovered:
                mttr = self._clock() - self._recover_t0
                self._recover_t0 = None
                self._recovering_rids.clear()
                # whose work just recovered — the aggregate carries the
                # window's tenant membership (list, like "failover")
                tenants = sorted(self._recovering_tenants)
                self._recovering_tenants.clear()
                self._mttr_last = mttr
                self._mttr_sum += mttr
                self._mttr_count += 1
                self.ring.append("recovery_done",
                                 mttr_s=round(mttr, 6),
                                 fleet_step=self._step_no,
                                 **({"tenants": tenants}
                                    if tenants else {}))
                self.metrics.histogram(
                    "fleet_mttr_seconds",
                    help="failover to first post-recovery progress of "
                         "reclaimed work"
                ).observe(mttr)
        self._update_gauges()
        return out

    # -- dispatch / routing ------------------------------------------------
    def _candidates(self) -> List[int]:
        cands = []
        for i, rep in enumerate(self.replicas):
            h = self.health[i]
            if not h.admissible():
                continue
            inflight_here = sum(1 for k in self._inflight if k[0] == i)
            if h.circuit == "half_open":
                # half-open admits exactly ONE probe request
                if inflight_here == 0 and rep.free_slots() > 0:
                    cands.append(i)
                continue
            if (rep.free_slots() > 0
                    or rep.queue_depth() < self.replica_queue_cap):
                cands.append(i)
        # prefer healthy replicas — but a half-open replica MUST stay
        # eligible or its recovery probe never dispatches under
        # non-saturating load and it idles degraded forever (the
        # one-probe budget above keeps the risk to a single request)
        preferred = [i for i in cands
                     if self.health[i].state == HEALTHY
                     or self.health[i].circuit == "half_open"]
        return preferred or cands

    def _dispatch(self):
        if not self._pending:
            return
        # candidate capacity only changes when a dispatch lands (or
        # fails), so recompute per outcome, not per queued request —
        # the backlog can be hundreds deep and this loop is per tick.
        # The snapshot is in WFQ order: the stride schedule decides
        # who meets the router first, the router only decides WHERE.
        cands = self._candidates()
        for req in list(self._pending):
            if req.next_attempt_step > self._step_no:
                continue
            if not cands:
                # no capacity anywhere — the QoS escape hatch: a
                # dispatchable high-class request may evict a strictly
                # lower-class in-flight one (decode preemption).  If
                # there is no eligible victim either, capacity is
                # request-independent and the sweep ends.
                if not self._try_preempt(req):
                    break
                cands = self._candidates()
                if not cands:
                    # eviction freed capacity on a replica the breaker
                    # currently refuses — nothing more this tick
                    break
            elif (self._qos_active
                    and not any(self.replicas[j].free_slots() > 0
                                for j in cands)):
                # every candidate would only QUEUE the request behind
                # work already decoding — for a class that outranks an
                # in-flight victim that is a priority inversion, not
                # admission: evict first so the request lands on a
                # real slot.  No victim → fall through and queue.
                if self._try_preempt(req):
                    cands = self._candidates()
                    if not cands:
                        break
            i = self.policy.select(self, cands, req)
            rep = self.replicas[i]
            # routing decision + dispatch attempt on the request's
            # trace; activating the dispatch event around rep.submit
            # parents the engine's own queue/prefill spans under it
            # (submit runs on the fleet thread — ambient is safe here)
            decision = getattr(self.policy, "last_decision", None)
            self._trace_ev(req, "fleet_route", replica=i,
                           policy=getattr(self.policy, "name",
                                          type(self.policy).__name__),
                           attempt=req.attempts,
                           candidates=list(cands),
                           **({"decision": decision} if decision
                              else {}))
            dspan = self._trace_ev(req, "fleet_dispatch", replica=i)
            amb = (tracing.get_recorder().activate(req.trace_id, dspan)
                   if dspan is not None else contextlib.nullcontext())
            # replicas advertising accepts_tenant get the tag so their
            # engine-side spans (queue/prefill) carry it too; stubs and
            # proxies without the flag keep the pre-tenant signature
            tkw = ({"tenant": req.tenant}
                   if req.tenant is not None
                   and getattr(rep, "accepts_tenant", False) else {})
            try:
                with amb:
                    rrid = rep.submit(req.prompt, req.max_new, req.eos,
                                      req.seed, req.temperature, **tkw)
            except ValueError as e:
                # request-shaped rejection (bad prompt length, seed on
                # a greedy engine, ...): the replica is fine and no
                # other replica would take it either — fail, no retry
                self._pending.remove(req)
                self._trace_ev(req, "fleet_reject", replica=i,
                               error=str(e))
                self._fail(req, f"rejected at dispatch: {e}")
                continue
            except Exception as e:      # noqa: BLE001 — replica fault
                self.health[i].record_error()
                self._n_retries += 1
                self._m_retries.inc()
                req.attempts += 1
                # one ring event per (replica, tick): a deep backlog
                # failing dispatch onto one sick replica is a single
                # transition, not len(backlog) of them — the counter
                # carries the volume (same rule as shed/deadline)
                if i not in self._tick_retry_logged:
                    self._tick_retry_logged.add(i)
                    self.ring.append("dispatch_retry", replica=i,
                                     rid=req.rid, attempt=req.attempts,
                                     error=str(e))
                if req.attempts >= self.retry.max_attempts:
                    self._pending.remove(req)
                    self._trace_ev(req, "fleet_retries_exhausted",
                                   replica=i, attempts=req.attempts)
                    self._fail(req, f"dispatch failed after "
                                    f"{req.attempts} attempts; last: "
                                    f"{e}")
                else:
                    req.next_attempt_step = (
                        self._step_no
                        + self.retry.delay_steps(req.attempts - 1))
                    self._trace_ev(req, "fleet_retry_backoff",
                                   replica=i, attempt=req.attempts,
                                   next_attempt_step=
                                   req.next_attempt_step)
                cands = self._candidates()   # health may have tripped
                continue
            self._pending.remove(req)
            req.assigned = (i, rrid)
            self._inflight[(i, rrid)] = req
            # first dispatch closes the request's queue-wait window
            # (a failover's re-dispatch is service time — the tracker
            # keeps only the first)
            self.slo.on_dispatch(req.rid, self._clock())
            cands = self._candidates()       # replica i consumed capacity
        # a reclaimed request can exhaust its budget inside this sweep
        # (rejection or repeated dispatch failure): if that emptied
        # the MTTR watch set, close the window sample-free
        self._abandon_recovery()

    # -- decode preemption -------------------------------------------------
    def _try_preempt(self, req: "_FleetRequest") -> bool:
        """Evict one in-flight request of a STRICTLY lower class to
        make room for ``req``.  The victim is chosen
        deterministically: lowest class first (highest rank number),
        then fewest harvested tokens, then the YOUNGEST request
        (highest rid) — the least sunk work to redo.  Eviction goes
        through the replica's ``preempt()`` when it has one (the
        engine scheduler's eviction API: paged replicas free the
        victim's KV blocks through the in-graph recycling path —
        eager host-side ops, so a warmed fleet preempts with zero new
        traces) and falls back to ``cancel()``.  The evictee
        re-queues at the FRONT of its own class queue and restarts
        from its prompt exactly like a failed-over request, so its
        final ``result()`` stays token-for-token what an undisturbed
        run produces (greedy / explicitly-seeded decodes are
        request-intrinsic).  A preemption is not a failure: the
        victim's retry budget is untouched."""
        if not self._qos_active:
            return False
        rank = self.qos.rank(req.qos_class)
        victims = [(key, r) for key, r in self._inflight.items()
                   if r.qos_class is not None
                   and self.qos.rank(r.qos_class) > rank
                   and self.qos.preemptible(r.qos_class)
                   and self.health[key[0]].admissible()]
        if not victims:
            return False
        key, victim = max(
            victims,
            key=lambda kv: (self.qos.rank(kv[1].qos_class),
                            -len(kv[1].generated), kv[1].rid))
        i, rrid = key
        rep = self.replicas[i]
        try:
            fn = getattr(rep, "preempt", None)
            if callable(fn):
                fn(rrid)
            else:
                rep.cancel(rrid)
        except Exception:               # noqa: BLE001 — best-effort,
            pass                        # like _replica_failed's cancel
        del self._inflight[key]
        victim.assigned = None
        victim.generated = []
        victim.preemptions += 1
        victim.next_attempt_step = self._step_no  # eligible at once
        self._n_preempted += 1
        self._m_preempted.inc()
        self.slo.on_preempt(victim.qos_class)
        # preemption is an aggregate two-party event: the ?tenant=
        # membership filter must find it from EITHER side, so both
        # tenants ride in the ``tenants`` list
        tenants = sorted({t for t in (victim.tenant, req.tenant)
                          if t is not None})
        self.ring.append("preemption", replica=i,
                         evicted_rid=victim.rid,
                         evicted_class=victim.qos_class,
                         admitted_rid=req.rid,
                         admitted_class=req.qos_class,
                         fleet_step=self._step_no,
                         **({"tenants": tenants} if tenants else {}))
        self._trace_ev(victim, "fleet_preempted", replica=i,
                       by_rid=req.rid, by_class=req.qos_class,
                       preemptions=victim.preemptions)
        self._pending[:0] = [victim]
        return True

    # -- failure handling --------------------------------------------------
    def _replica_failed(self, i: int, reason: str):
        """Record the error (the breaker may open) and fail over every
        fleet request on replica ``i`` — reclaimed, best-effort
        cancelled there, and restarted from their prompts on whoever
        the router picks next tick."""
        self.health[i].record_error()
        # a raise mid-step must not carry a previously accumulated
        # stall count into the replica's next life — the watchdog
        # would fire on its first slow tick after recovery
        self._idle_steps[i] = 0
        rep = self.replicas[i]
        keys = sorted((k for k in self._inflight if k[0] == i),
                      key=lambda k: self._inflight[k].rid)
        if self._recover_t0 is None:
            # MTTR opens at the FIRST failure of the episode; a second
            # replica dying mid-recovery extends the same window.  It
            # closes at the first post-recovery progress OF RECLAIMED
            # WORK (the rids collected below) — a survivor's unrelated
            # token does not mean the failed-over requests recovered.
            self._recover_t0 = self._clock()
        # whose requests suffered: the distinct tenants among the
        # reclaimed work (aggregate event, so a list — /flightz's
        # ?tenant= filter matches membership)
        tenants = sorted({self._inflight[k].tenant for k in keys
                          if self._inflight[k].tenant is not None})
        self.ring.append("failover", replica=i, reason=reason,
                         reclaimed=len(keys), fleet_step=self._step_no,
                         **({"tenants": tenants} if tenants else {}))
        moved = []
        for key in keys:
            req = self._inflight.pop(key)
            try:
                rep.cancel(key[1])
            except Exception:           # noqa: BLE001 — sick replica
                pass
            req.assigned = None
            req.restarts += 1
            req.attempts += 1
            req.generated = []
            self._n_failovers += 1
            self._m_failover.inc()
            # the failure hop of the request's causal chain: the fault
            # on the sick replica, then the reclaim that re-queues it
            # for the router — the next fleet_route/fleet_dispatch pair
            # (on a survivor) chains on the reclaim event
            self._trace_ev(req, "fleet_fault", replica=i, reason=reason)
            if req.attempts >= self.retry.max_attempts:
                self._fail(req, f"failed over {req.restarts}x "
                                f"(attempt budget exhausted); replica "
                                f"{i}: {reason}")
            else:
                req.next_attempt_step = self._step_no + 1
                self._trace_ev(req, "fleet_reclaim", replica=i,
                               restarts=req.restarts,
                               attempts=req.attempts)
                moved.append(req)
                self._recovering_rids.add(req.rid)
                if req.tenant is not None:
                    self._recovering_tenants.add(req.tenant)
        # leftovers in the replica's own waiting queue (queued-on-
        # replica dispatches) came back via the keys above; anything
        # else there was submitted behind the fleet's back — drop it
        # back out so the sick replica holds no queued work
        try:
            rep.take_waiting()
        except Exception:               # noqa: BLE001
            pass
        # restarted requests go to the FRONT in submission order: they
        # were admitted before anything still pending
        self._pending[:0] = moved
        # a failover that reclaimed nothing rescuable (idle replica,
        # or every request's budget already spent) closes its MTTR
        # window right here, sample-free
        self._abandon_recovery()
        if self.flight_dump_path:
            # post-mortem artifact the moment something broke — not at
            # process exit, which a wedged replica may never reach
            try:
                self.ring.dump(self.flight_dump_path)
            except OSError:
                pass

    def _abandon_recovery(self):
        """Nothing left to rescue (the dead replica held no fleet
        work, or every reclaimed request resolved as a failure): close
        the MTTR window WITHOUT a sample — letting it wait for
        unrelated future progress would report idle time as recovery
        time and absorb the next real failover into a stale window.
        Called only at the END of a reclaim/deadline/dispatch sweep,
        never mid-loop: a budget-exhausted request failed early in
        ``_replica_failed``'s loop must not abandon the window the
        requests still being reclaimed behind it are about to join."""
        if self._recover_t0 is not None and not self._recovering_rids \
                and not self._recovered_tick:
            self._recover_t0 = None
            self._recovering_tenants.clear()
            self.ring.append("recovery_abandoned",
                             fleet_step=self._step_no)

    def _fail(self, req: _FleetRequest, msg: str,
              deadline_exceeded: bool = False):
        # a reclaimed request that dies (budget/deadline) is resolved,
        # not recovered — drop it from the MTTR watch set (the sweep
        # that called us decides afterwards whether the window is now
        # empty and must be abandoned)
        self._recovering_rids.discard(req.rid)
        req.error = msg
        req.t_finish = self._clock()
        self._results[req.rid] = req
        self._n_failed += 1
        self._m_failed.inc()
        self.slo.on_fail(req.rid, req.t_finish,
                         deadline_exceeded=deadline_exceeded)
        self._trace_ev(req, "fleet_failed", error=msg)

    def _finish(self, req: _FleetRequest, tokens: List[int]):
        if self._recover_t0 is not None \
                and req.rid in self._recovering_rids:
            # a reclaimed request FINISHING is the strongest form of
            # post-recovery progress; flag it before dropping the rid
            # so the end-of-tick close still sees it
            self._recovered_tick = True
        self._recovering_rids.discard(req.rid)
        req.generated = [int(t) for t in tokens]
        req.t_finish = self._clock()
        self._results[req.rid] = req
        self._n_finished += 1
        self._m_finished.inc()
        self._n_tokens += len(req.generated)
        self._m_tokens.inc(len(req.generated))
        self.slo.on_finish(req.rid, req.t_finish, len(req.generated))
        if req.t_submit is not None:
            self._m_latency.observe(req.t_finish - req.t_submit)
        self._trace_ev(req, "fleet_result", tokens=len(req.generated),
                       restarts=req.restarts,
                       latency_s=round(req.t_finish - req.t_submit, 6)
                       if req.t_submit is not None else None)

    def _check_deadlines(self):
        now = self._clock()
        expired: List[_FleetRequest] = []
        for req in [r for r in self._pending
                    if r.deadline_at is not None
                    and now > r.deadline_at]:
            self._pending.remove(req)
            expired.append(req)
        for key, req in list(self._inflight.items()):
            if req.deadline_at is not None and now > req.deadline_at:
                del self._inflight[key]
                try:
                    self.replicas[key[0]].cancel(key[1])
                except Exception:       # noqa: BLE001
                    pass
                expired.append(req)
        if expired:
            # ONE ring event per sweep, like the shed episode: a
            # shared client deadline can expire the whole queue in a
            # single tick, and thousands of per-request events would
            # wheel the bounded ring past the breaker/failover history
            # a post-mortem needs.  The counter carries the volume.
            sweep = {"count": len(expired),
                     "rids": [r.rid for r in expired[:8]],
                     "fleet_step": self._step_no}
            tenants = sorted({r.tenant for r in expired
                              if r.tenant is not None})
            if tenants:
                sweep["tenants"] = tenants
            self._last_deadline_sweep = sweep
            self.ring.append("deadline_exceeded", **sweep)
        for req in expired:
            self._deadline_fail(req)
        if expired:
            self._abandon_recovery()

    def _deadline_fail(self, req: _FleetRequest):
        self._n_deadline += 1
        self._m_deadline.inc()
        self._fail(req, f"deadline exceeded after "
                        f"{self._clock() - req.t_submit:.3f}s",
                   deadline_exceeded=True)

    # -- drain / rolling restart -------------------------------------------
    def drain(self, i: int):
        """Graceful drain of replica ``i``: stop admitting, re-enqueue
        its waiting queue onto the fleet (→ survivors), keep stepping
        its in-flight requests to completion; the replica then parks
        ``drained`` until :meth:`undrain`."""
        h = self.health[i]
        if h.draining or h.drained:
            return
        h.start_drain()
        self._n_drains += 1
        self._m_drains.inc()
        moved = []
        try:
            taken = self.replicas[i].take_waiting()
        except Exception:               # noqa: BLE001
            taken = []
        for rrid, *_ in taken:
            req = self._inflight.pop((i, rrid), None)
            if req is not None:
                req.assigned = None
                req.next_attempt_step = self._step_no
                moved.append(req)
        moved.sort(key=lambda r: r.rid)
        self.ring.append("drain", replica=i, requeued=len(moved),
                         fleet_step=self._step_no)
        for req in moved:
            self._trace_ev(req, "fleet_drain_requeue", replica=i)
        self._pending[:0] = moved
        if not any(k[0] == i for k in self._inflight):
            h.finish_drain()

    def undrain(self, i: int):
        """Re-enlist a drained (or draining) replica with a fresh
        health record — the post-rolling-restart handshake."""
        self.health[i].reset()

    # -- results / introspection -------------------------------------------
    def result(self, rid: int) -> List[int]:
        """Final tokens of a finished request; raises ``KeyError`` if
        unknown/unfinished and ``RuntimeError`` if the request failed
        (retries exhausted, rejected, or deadline exceeded)."""
        req = self._results[rid]
        if req.error is not None:
            raise RuntimeError(f"request {rid} failed: {req.error}")
        return list(req.generated)

    def request_trace_id(self, rid: int) -> Optional[str]:
        """The distributed-trace id minted for request ``rid`` at
        submit ("<fleet_trace>/r<rid>"), or None when tracing is off.
        Feed it to ``observability.get_recorder().trace(...)`` /
        ``trace_record(...)`` for the request's full causal span chain
        (submit → route → dispatch → [fault → reclaim → ...] →
        result)."""
        return self._trace_ids.get(rid)

    def trace_record(self, rid: int) -> Dict[str, Any]:
        """The ``kind: trace`` JSONL record of request ``rid``'s
        flight (``exporters.validate_trace_record`` pins the shape);
        raises ``KeyError`` when the request was never traced."""
        tid = self._trace_ids.get(rid)
        if tid is None:
            raise KeyError(f"request {rid} has no trace (tracing "
                           f"disabled or unknown rid)")
        return tracing.get_recorder().trace_record(tid)

    def close(self):
        """Join the step-worker pool (idempotent).  A later ``step()``
        lazily recreates it, so close when the fleet is retired — the
        pool's threads are non-daemon and otherwise live until
        interpreter exit."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def latency(self, rid: int) -> float:
        """Submit-to-finish seconds for a completed (or failed)
        request — the per-request tail-latency surface ``bench.py
        --fleet`` percentiles over; raises ``KeyError`` while the
        request is still in flight."""
        req = self._results[rid]
        return req.t_finish - req.t_submit

    def status(self, rid: int) -> str:
        """``queued`` / ``inflight`` / ``finished`` / ``failed``."""
        if rid in self._results:
            return ("failed" if self._results[rid].error is not None
                    else "finished")
        if any(r.rid == rid for r in self._pending):
            return "queued"
        if any(r.rid == rid for r in self._inflight.values()):
            return "inflight"
        raise KeyError(f"unknown request id {rid}")

    def live(self) -> int:
        """Requests still owed an outcome (queued + in-flight)."""
        return len(self._pending) + len(self._inflight)

    def queue_depth(self) -> int:
        """Fleet-queue depth — the cheap accessor the SLO controller
        reads every control tick (``stats()`` builds histogram
        summaries; this is one ``len``)."""
        return len(self._pending)

    def inflight(self) -> int:
        """In-flight request count (cheap, controller-facing)."""
        return len(self._inflight)

    def mttr(self) -> Dict[str, Any]:
        """Fleet MTTR aggregate: failover → first post-recovery
        progress, ``{last, mean, count}`` seconds (``None`` until a
        recovery completed)."""
        return {"last": self._mttr_last,
                "mean": (self._mttr_sum / self._mttr_count
                         if self._mttr_count else None),
                "count": self._mttr_count}

    def begin_recovery(self, reason: str = ""):
        """Mark an INTENTIONAL recovery in flight (controller world
        shrink, operator intervention): while set, the introspection
        server's no-steppable-replica check reports degraded-but-live
        ``recovering`` instead of 503 — an orchestrator probe must not
        restart-loop a fleet that is being handled."""
        if not self.recovery_in_flight:
            self.recovery_in_flight = True
            self.ring.append("fleet_recovery_begin", reason=reason,
                             fleet_step=self._step_no)

    def end_recovery(self):
        if self.recovery_in_flight:
            self.recovery_in_flight = False
            self.ring.append("fleet_recovery_end",
                             fleet_step=self._step_no)

    def states(self) -> List[str]:
        return [h.state for h in self.health]

    def tenant_stats(self) -> Dict[str, Any]:
        """The per-tenant rollup (``/tenantz``'s fleet source): every
        tenant's SLO/goodput tallies under one goodput window (the
        ``stats()`` discipline: extended to now while work is live),
        the tracker's overflow-fold count, the per-metric label drop
        accounting from the registry cardinality cap, and the
        per-CLASS split the ``?class=`` filter serves."""
        now = self._clock() if self.live() else None
        drops = {m.name: m.labels_dropped
                 for m in self.metrics.collect() if m.labels_dropped}
        return {"tenants": self.slo.tenant_stats(now=now),
                "tenants_dropped": self.slo.tenants_dropped,
                "classes": self._class_block(
                    self.slo.class_stats(now=now)),
                "preemptions": self._n_preempted,
                "label_sets_dropped": drops}

    def _class_block(self, slo_classes: Dict[str, Any]) -> \
            Dict[str, Any]:
        """Merge the tracker's per-class SLO tallies with the queue
        plane (per-class depth, effective quota) and the policy spec
        so one block answers both 'how is the class doing' and 'what
        did we promise it'.  Every POLICY class appears even before
        traffic — a dashboard keying on the interactive class must
        not 404 during the first quiet minute."""
        depths = self._pending.class_depths()
        out: Dict[str, Any] = {}
        for name, cls in self.qos.classes.items():
            b = dict(slo_classes.get(name)
                     or self.slo.zero_class_stats())
            b["queue_depth"] = depths.get(name, 0)
            b["weight"] = cls.weight
            b["queue_cap"] = self.qos.cap(name, self.max_queue)
            b["preemptible"] = cls.preemptible
            out[name] = b
        for name, b in slo_classes.items():   # classes a policy swap
            if name not in out:               # orphaned: keep tallies
                out[name] = dict(b)
        return out

    def _update_gauges(self):
        m = self.metrics
        m.gauge("fleet_queue_depth").set(float(len(self._pending)))
        if self._qos_active:
            g = m.gauge("fleet_class_queue_depth")
            for name, d in self._pending.class_depths().items():
                g.labels(qos_class=name).set(float(d))
        states = self.states()
        for s, g in ((HEALTHY, "fleet_replicas_healthy"),
                     (DEGRADED, "fleet_replicas_degraded"),
                     (DEAD, "fleet_replicas_dead")):
            m.gauge(g).set(float(states.count(s)))
        occ = m.gauge("fleet_replica_occupancy")
        liv = m.gauge("fleet_replica_live")
        qd = m.gauge("fleet_replica_queue_depth")
        st = m.gauge("fleet_replica_state_code",
                     help="0 healthy, 1 degraded, 2 dead, 3 draining, "
                          "4 drained")
        for i, rep in enumerate(self.replicas):
            # cheap accessors, not stats(): this runs every tick and
            # stats() builds five histogram summaries per replica
            lbl = {"replica": i}
            occ.labels(**lbl).set(rep.live() / rep.slots)
            liv.labels(**lbl).set(float(rep.live()))
            qd.labels(**lbl).set(float(rep.queue_depth()))
            st.labels(**lbl).set(float(STATE_CODES[states[i]]))

    def stats(self) -> Dict[str, Any]:
        """Aggregated snapshot: fleet totals, per-replica health
        states (summaries AND full :meth:`health.ReplicaHealth.
        snapshot` records — the ``/statusz`` view), the SLO/goodput
        aggregates (``slo`` + top-level ``goodput_tokens_per_s``), the
        last deadline-sweep aggregate, and every replica's own
        ``stats()``."""
        states = self.states()
        # one window for every goodput figure in this snapshot: extend
        # to now while work is live, freeze at the last finish after
        slo = self.slo.stats(now=self._clock() if self.live()
                             else None)
        return {"replicas": len(self.replicas),
                "policy": getattr(self.policy, "name",
                                  type(self.policy).__name__),
                "queue_depth": len(self._pending),
                "inflight": len(self._inflight),
                "submitted": self._n_submitted,
                "finished": self._n_finished,
                "failed": self._n_failed,
                "tokens_generated": self._n_tokens,
                "shed": self._n_shed,
                "retries": self._n_retries,
                "failovers": self._n_failovers,
                "drains": self._n_drains,
                "deadline_exceeded": self._n_deadline,
                "deadline_last_sweep": dict(self._last_deadline_sweep),
                "preemptions": self._n_preempted,
                "mttr": self.mttr(),
                "recovery_in_flight": self.recovery_in_flight,
                "slo": slo,
                "goodput_tokens_per_s": slo["goodput_tokens_per_s"],
                "tenants": slo["tenants"],
                "tenants_dropped": slo["tenants_dropped"],
                "classes": self._class_block(slo["classes"]),
                "states": states,
                "healthy": states.count(HEALTHY),
                "degraded": states.count(DEGRADED),
                "dead": states.count(DEAD),
                "draining": states.count(DRAINING),
                "drained": states.count(DRAINED),
                "health": [h.snapshot() for h in self.health],
                "request_latency": self._m_latency.summary(),
                "replica_stats": [r.stats() for r in self.replicas]}

    def record(self) -> Dict[str, Any]:
        """The ``kind: fleet`` JSONL record
        (``observability.exporters.validate_fleet_record``); feed it
        through a :class:`~apex_tpu_torch.observability.exporters.JsonlExporter`
        (or ``JsonlExporter.enrich``) to stamp the envelope.  Schema
        v5 adds the SLO/goodput fields and the deadline-sweep
        aggregate (optional in the validator, so archived records
        stay clean); v11 adds the per-tenant block — one compact
        tally per tenant (no histogram summaries; ``/tenantz`` has
        those) plus the overflow-fold count; v14 adds the per-CLASS
        block (same stripping rule) and the fleet preemption total."""
        s = self.stats()
        tenants = {t: {k: v for k, v in b.items()
                       if k not in ("queue_wait", "service_time")}
                   for t, b in s["tenants"].items()}
        classes = {c: {k: v for k, v in b.items()
                       if k not in ("queue_wait", "service_time")}
                   for c, b in s["classes"].items()}
        return {"kind": "fleet", "trace_id": self.trace_id,
                "tenants": tenants,
                "tenants_dropped": s["tenants_dropped"],
                "classes": classes,
                "preemptions": s["preemptions"],
                "replicas": s["replicas"], "policy": s["policy"],
                "healthy": s["healthy"], "degraded": s["degraded"],
                "dead": s["dead"],
                "queue_depth": s["queue_depth"],
                "submitted": s["submitted"], "finished": s["finished"],
                "failed": s["failed"], "shed": s["shed"],
                "retries": s["retries"], "failovers": s["failovers"],
                "drains": s["drains"],
                "tokens": s["tokens_generated"],
                "deadline_exceeded": s["deadline_exceeded"],
                "deadline_last_sweep": s["deadline_last_sweep"],
                "goodput_tokens_per_s": s["goodput_tokens_per_s"],
                "slo_attainment": s["slo"]["slo_attainment"],
                "tokens_within_slo": s["slo"]["goodput_tokens"],
                "mttr": s["mttr"]}
