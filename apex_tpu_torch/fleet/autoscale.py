"""Self-healing serving: the telemetry→action loop, serving side.

:class:`SloController` closes the loop ``fleet/slo.py``
opened: every control tick it reads the :class:`~apex_tpu_torch.fleet.slo.
SloTracker`'s queue-wait vs service split and deadline attainment —
the SAME flushed aggregates ``/statusz`` serves, nothing new is
measured — and actuates only what the fleet already exposes:

- **admission bound** — ``Fleet.max_queue``, the bounded-queue shed
  knob: tightening it under overload converts would-be deadline
  misses into immediate, retriable ``FleetOverloaded`` sheds, so the
  requests that ARE admitted still meet their deadlines (goodput over
  raw throughput, the goodput argument closed into an actuator);
- **drain / undrain** — capacity out and in (``Fleet.drain`` /
  ``undrain``): queue-wait dominance with a drained replica parked is
  the signal to re-enlist it; sustained idleness (opt-in
  ``scale_in``) is the signal to park one;
- **the breaker's step-counted cooldowns** —
  :meth:`~apex_tpu_torch.fleet.health.ReplicaHealth.set_cooldown`: when the
  fleet is starved AND a circuit is open, shorten the remaining
  cooldown so the half-open probe fires sooner; when a replica keeps
  failing probes under light load, leave the breaker's own
  exponential backoff alone;
- **decode window size** — duck-typed ``set_window(k)`` on replicas
  that support it (the port's ``Engine`` captures its window into
  the ``_step_k`` graph, so live window actuation applies to replicas built for
  it — stub/elastic replicas in the chaos harness, or an engine
  wrapper that pre-compiles several window sizes).  A larger window
  buys throughput per host sync; a smaller one sheds per-request
  latency under a deadline crunch.

Decisions are DETERMINISTIC and hysteretic: attainment and the
wait/service split are computed as per-tick DELTAS of the tracker's
cumulative aggregates (no wall-clock windows — tick-exact under the
fault harness's injected clocks), an overload EPISODE opens on the
transition past the thresholds, at most one actuation fires per
``cooldown_ticks``, and ``max_actions_per_episode`` bounds the total
— the no-oscillation contract ``tests/ci/chaos_smoke.py`` gates.
Episodes, actions and MTTR share :class:`~apex_tpu_torch.fleet.recovery.
RecoveryLog` with the training controller, so both directions of the
loop emit one ``kind: recovery`` record shape
(``observability.exporters.validate_recovery_record``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from .health import HEALTHY
from .recovery import RecoveryLog

__all__ = ["AutoscaleConfig", "SloController"]


class AutoscaleConfig:
    """Control-loop thresholds (all tick-counted, deterministic under
    injected clocks).

    - ``target_attainment``: recent (per-tick delta) deadline
      attainment below this opens an overload episode;
    - ``queue_wait_dominance``: queue-wait mean exceeding this multiple
      of the service mean — with work actually queued — also counts as
      overload (the fleet had no capacity; the replicas were fine);
    - ``backlog_factor``: a fleet queue deeper than this multiple of
      the replicas' combined slot capacity counts as overload
      IMMEDIATELY — the leading-edge signal: a spike is visible in the
      backlog the tick it lands, a full service time before its first
      deadline miss can resolve;
    - ``min_queue``: the admission bound is never tightened below this
      (an admission bound of 0 would be a full outage, not control);
    - ``cooldown_ticks``: at least this many control ticks between
      actuations (hysteresis — let the last action take effect before
      judging it);
    - ``relax_after_ticks``: healthy ticks required before the
      controller starts undoing its own tightening;
    - ``max_actions_per_episode``: hard bound on actuations per
      overload episode — exceeding it stops actuating and leaves the
      episode for a human (chaos_smoke asserts the bound holds);
    - ``probe_cooldown_steps``: what an open breaker's remaining
      cooldown is shortened to when the fleet is starved;
    - ``window_bounds``: ``(min, max)`` decode window the duck-typed
      ``set_window`` actuator may choose;
    - ``scale_in`` / ``idle_ticks_to_drain``: opt-in scale-in — drain
      one healthy replica after that many consecutive idle ticks.
    """

    def __init__(self, target_attainment: float = 0.9,
                 queue_wait_dominance: float = 2.0,
                 backlog_factor: float = 2.0,
                 min_queue: int = 4,
                 cooldown_ticks: int = 2,
                 relax_after_ticks: int = 4,
                 max_actions_per_episode: int = 8,
                 probe_cooldown_steps: int = 1,
                 window_bounds=(1, 32),
                 scale_in: bool = False,
                 idle_ticks_to_drain: int = 8):
        if not (0.0 < target_attainment <= 1.0):
            raise ValueError(f"target_attainment must be in (0, 1], "
                             f"got {target_attainment}")
        if queue_wait_dominance <= 1.0:
            raise ValueError(f"queue_wait_dominance must be > 1, got "
                             f"{queue_wait_dominance}")
        if backlog_factor <= 0.0:
            raise ValueError(f"backlog_factor must be > 0, got "
                             f"{backlog_factor}")
        if min_queue < 1:
            raise ValueError(f"min_queue must be >= 1, got {min_queue}")
        if cooldown_ticks < 1 or relax_after_ticks < 1:
            raise ValueError("cooldown_ticks and relax_after_ticks "
                             "must be >= 1")
        if max_actions_per_episode < 1:
            raise ValueError(f"max_actions_per_episode must be >= 1, "
                             f"got {max_actions_per_episode}")
        if probe_cooldown_steps < 1:
            raise ValueError(f"probe_cooldown_steps must be >= 1, got "
                             f"{probe_cooldown_steps}")
        lo, hi = window_bounds
        if not (1 <= lo <= hi):
            raise ValueError(f"window_bounds must satisfy "
                             f"1 <= min <= max, got {window_bounds}")
        if idle_ticks_to_drain < 1:
            raise ValueError(f"idle_ticks_to_drain must be >= 1, got "
                             f"{idle_ticks_to_drain}")
        self.target_attainment = target_attainment
        self.queue_wait_dominance = queue_wait_dominance
        self.backlog_factor = backlog_factor
        self.min_queue = min_queue
        self.cooldown_ticks = cooldown_ticks
        self.relax_after_ticks = relax_after_ticks
        self.max_actions_per_episode = max_actions_per_episode
        self.probe_cooldown_steps = probe_cooldown_steps
        self.window_bounds = (int(lo), int(hi))
        self.scale_in = scale_in
        self.idle_ticks_to_drain = idle_ticks_to_drain


class SloController:
    """SLO-feedback controller over one :class:`~apex_tpu_torch.fleet.Fleet`.

    Call :meth:`tick` once per control interval (every N fleet steps —
    the caller owns the cadence, typically the same loop that calls
    ``fleet.step()``); each tick reads the tracker deltas, classifies
    the fleet as overloaded / healthy, and actuates AT MOST one knob.
    Returns the actions taken (empty list = no actuation needed)."""

    def __init__(self, fleet, config: Optional[AutoscaleConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 ring=None, registry=None):
        self.fleet = fleet
        self.config = config or AutoscaleConfig()
        self._clock = clock if clock is not None else fleet._clock
        self.log = RecoveryLog("serving",
                               getattr(fleet, "trace_id", "fleet"),
                               clock=self._clock, ring=ring,
                               registry=registry)
        self.base_max_queue = int(fleet.max_queue)
        # per-class actuation: with a multi-class QosPolicy on
        # the fleet, admission tightens PER CLASS — the batch class's
        # queue_share halves while the interactive class's quota is
        # never touched.  Baseline shares snapshot here so relax can
        # restore them exactly (including a None = unbounded share).
        self._qos = getattr(fleet, "qos", None)
        self._qos_active = bool(getattr(fleet, "_qos_active", False)
                                and self._qos is not None)
        self._base_shares = (
            {name: c.queue_share
             for name, c in self._qos.classes.items()}
            if self._qos_active else {})
        # replicas' combined slot capacity — the backlog signal's
        # yardstick (replicas without a slots attribute count as 1)
        self.total_slots = sum(int(getattr(r, "slots", 1))
                               for r in fleet.replicas)
        # baseline decode windows, snapshotted at construction like
        # base_max_queue: the grow actuator restores TOWARD these, so
        # a replica the controller shrank is never left small forever
        # just because it lacks some extra attribute
        self._base_windows = {
            i: int(r.window) for i, r in enumerate(fleet.replicas)
            if hasattr(r, "set_window") and hasattr(r, "window")}
        self._ticks = 0
        self._last_action_tick = -10**9
        self._healthy_ticks = 0
        self._idle_ticks = 0
        # fleet MTTR measurements already accounted for: start at the
        # CURRENT count, so a recovery that completed before this
        # controller attached can never be mis-attributed to its
        # first episode (the supervisor's ring-watermark discipline)
        self._mttr_seen = int(fleet.mttr()["count"])
        # cumulative-tracker watermarks for the per-tick deltas
        self._seen_with = 0
        self._seen_within = 0
        self._seen_wait = (0, 0.0)       # (count, sum)
        self._seen_service = (0, 0.0)
        self.last_signal: Dict[str, Any] = {}

    # -- signal extraction (cheap accessors + tracker deltas) --------------
    def _signal(self) -> Dict[str, Any]:
        slo = self.fleet.slo
        stats = slo.stats()
        dw = stats["with_deadline"] - self._seen_with
        dwi = stats["within_deadline"] - self._seen_within
        self._seen_with = stats["with_deadline"]
        self._seen_within = stats["within_deadline"]
        attain = (dwi / dw) if dw > 0 else None

        def hist_delta(summary, seen):
            c = (summary["count"] or 0) - seen[0]
            s = (summary["sum"] or 0.0) - seen[1]
            return c, s, ((summary["count"] or 0),
                          (summary["sum"] or 0.0))

        wc, ws, self._seen_wait = hist_delta(stats["queue_wait"],
                                             self._seen_wait)
        sc, ss, self._seen_service = hist_delta(stats["service_time"],
                                                self._seen_service)
        return {"tick": self._ticks,
                "resolved_deadlined": dw,
                "attainment": attain,
                "queue_wait_mean": (ws / wc) if wc else None,
                "service_mean": (ss / sc) if sc else None,
                "queue_depth": self.fleet.queue_depth(),
                "inflight": self.fleet.inflight()}

    def _overloaded(self, sig: Dict[str, Any]) -> Optional[str]:
        cfg = self.config
        a = sig["attainment"]
        if a is not None and a < cfg.target_attainment:
            return (f"attainment {a:.3f} < target "
                    f"{cfg.target_attainment}")
        backlog = cfg.backlog_factor * self.total_slots
        if sig["queue_depth"] > backlog:
            return (f"backlog {sig['queue_depth']} > "
                    f"{cfg.backlog_factor} x {self.total_slots} slots")
        qw, sv = sig["queue_wait_mean"], sig["service_mean"]
        if (qw is not None and sv is not None and sv > 0
                and sig["queue_depth"] > 0
                and qw > cfg.queue_wait_dominance * sv):
            return (f"queue-wait mean {qw:.4f} dominates service mean "
                    f"{sv:.4f} with {sig['queue_depth']} queued")
        return None

    # -- actuators ----------------------------------------------------------
    def _window_replicas(self) -> List[Any]:
        return [(i, self.fleet.replicas[i])
                for i in sorted(self._base_windows)]

    def _class_cap(self, name: str) -> int:
        return self._qos.cap(name, self.fleet.max_queue)

    def _act_class_tighten(self, reason: str) \
            -> Optional[Dict[str, Any]]:
        """Halve the queue quota of the LOWEST-priority class that
        still has room to give, never the top class: shedding lands on
        the batch tier while the interactive tier's admission is
        untouched."""
        names = list(self._qos.classes)
        for name in reversed(names[1:]):    # lowest priority first;
            cap = self._class_cap(name)     # rank 0 is never tightened
            if cap > 1:
                new_cap = max(1, cap // 2)
                cls = self._qos.classes[name]
                cls.queue_share = new_cap / self.fleet.max_queue
                return self.log.action("class_admission_tighten",
                                       qos_class=name,
                                       queue_cap_from=cap,
                                       queue_cap_to=new_cap,
                                       reason=reason)
        return None

    def _act_class_relax(self) -> Optional[Dict[str, Any]]:
        """Restore one notch of a tightened class quota toward its
        baseline share (lowest-priority classes first — they were
        tightened first)."""
        names = list(self._qos.classes)
        for name in reversed(names[1:]):
            base_share = self._base_shares.get(name)
            base_cap = (self.fleet.max_queue if base_share is None
                        else max(1, int(base_share
                                        * self.fleet.max_queue)))
            cap = self._class_cap(name)
            if cap < base_cap:
                new_cap = min(base_cap, cap * 2)
                cls = self._qos.classes[name]
                cls.queue_share = (base_share if new_cap == base_cap
                                   else new_cap / self.fleet.max_queue)
                return self.log.action("class_admission_relax",
                                       qos_class=name,
                                       queue_cap_from=cap,
                                       queue_cap_to=new_cap)
        return None

    def _act_overload(self, reason: str) -> Optional[Dict[str, Any]]:
        """One actuation per tick, in fixed priority order: capacity
        back first (undrain, fast-probe a broken breaker), then load
        shedding (tighten admission — per CLASS when the fleet runs a
        multi-class QoS policy, so the batch tier sheds and the
        interactive tier is untouched), then latency (shrink
        windows)."""
        fl, cfg = self.fleet, self.config
        for i, h in enumerate(fl.health):
            if h.drained:
                fl.undrain(i)
                return self.log.action("undrain", replica=i,
                                       reason=reason)
        for i, h in enumerate(fl.health):
            if h.circuit == "open" \
                    and h.cooldown_left > cfg.probe_cooldown_steps:
                h.set_cooldown(max(h.config.cooldown_steps, 1),
                               remaining=cfg.probe_cooldown_steps)
                return self.log.action(
                    "cooldown_shorten", replica=i,
                    remaining=cfg.probe_cooldown_steps, reason=reason)
        if self._qos_active:
            # per-class shed: the global max_queue (and with it the
            # interactive class's quota) is deliberately NOT touched —
            # when every lower class is already at cap 1 the next
            # lever is latency (windows), not interactive admission
            act = self._act_class_tighten(reason)
            if act is not None:
                return act
        elif fl.max_queue > cfg.min_queue:
            new = max(cfg.min_queue, fl.max_queue // 2)
            old, fl.max_queue = fl.max_queue, new
            return self.log.action("admission_tighten",
                                   max_queue_from=old,
                                   max_queue_to=new, reason=reason)
        lo, _hi = cfg.window_bounds
        for i, r in self._window_replicas():
            if int(r.window) > lo:
                old = int(r.window)
                r.set_window(max(lo, old // 2))
                return self.log.action("window_shrink", replica=i,
                                       window_from=old,
                                       window_to=int(r.window),
                                       reason=reason)
        return None

    def _act_relax(self) -> Optional[Dict[str, Any]]:
        """Undo one notch of tightening after sustained health."""
        fl, cfg = self.fleet, self.config
        if self._qos_active:
            act = self._act_class_relax()
            if act is not None:
                return act
        if fl.max_queue < self.base_max_queue:
            new = min(self.base_max_queue, fl.max_queue * 2)
            old, fl.max_queue = fl.max_queue, new
            return self.log.action("admission_relax",
                                   max_queue_from=old,
                                   max_queue_to=new)
        _lo, hi = cfg.window_bounds
        for i, r in self._window_replicas():
            base = min(hi, self._base_windows[i])
            if int(r.window) < base:
                old = int(r.window)
                r.set_window(min(base, old * 2))
                return self.log.action("window_grow", replica=i,
                                       window_from=old,
                                       window_to=int(r.window))
        return None

    def _act_scale_in(self) -> Optional[Dict[str, Any]]:
        fl = self.fleet
        healthy = [i for i, h in enumerate(fl.health)
                   if h.state == HEALTHY]
        if len(healthy) > 1:
            i = healthy[-1]
            fl.drain(i)
            return self.log.action("drain", replica=i,
                                   reason="sustained idleness")
        return None

    # -- the control tick ---------------------------------------------------
    def tick(self) -> List[Dict[str, Any]]:
        cfg = self.config
        self._ticks += 1
        sig = self._signal()
        self.last_signal = sig
        # serving MTTR rides the fleet's own accounting (failover →
        # first post-recovery progress); the log mirrors each
        # completed measurement once — _mttr_seen advances ONLY when
        # a measurement is consumed (at episode close), so one that
        # completes while the episode is still open is not lost
        fm = self.fleet.mttr()
        actions: List[Dict[str, Any]] = []
        reason = self._overloaded(sig)
        can_act = (self._ticks - self._last_action_tick
                   >= cfg.cooldown_ticks)
        if reason is not None:
            self._healthy_ticks = 0
            self._idle_ticks = 0
            self.log.open_episode(reason, tick=self._ticks)
            if (can_act and self.log.actions_this_episode
                    < cfg.max_actions_per_episode):
                act = self._act_overload(reason)
                if act is not None:
                    actions.append(act)
                    self._last_action_tick = self._ticks
        else:
            self._healthy_ticks += 1
            if self.log.in_flight:
                fresh = fm["count"] > self._mttr_seen
                self.log.close_episode(
                    mttr_s=fm["last"] if fresh else None,
                    tick=self._ticks)
            # consume measurements only on healthy ticks: one that
            # completed mid-episode is mirrored by the close above; a
            # failover absorbed without any SLO impact stays on the
            # fleet's own mttr surface and is never mis-attributed to
            # a later unrelated episode
            self._mttr_seen = fm["count"]
            if (self._healthy_ticks >= cfg.relax_after_ticks
                    and can_act):
                act = self._act_relax()
                if act is not None:
                    actions.append(act)
                    self._last_action_tick = self._ticks
            if (cfg.scale_in and sig["queue_depth"] == 0
                    and sig["inflight"] == 0):
                self._idle_ticks += 1
                if (self._idle_ticks >= cfg.idle_ticks_to_drain
                        and can_act):
                    act = self._act_scale_in()
                    if act is not None:
                        actions.append(act)
                        self._last_action_tick = self._ticks
                        self._idle_ticks = 0
            else:
                self._idle_ticks = 0
        return actions

    # -- outputs ------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """The ``/statusz``-ready snapshot."""
        return {"ticks": self._ticks,
                "episode_open": self.log.in_flight,
                "episodes": self.log.episodes,
                "actions_total": self.log.actions_total,
                "max_actions_in_episode":
                    self.log.max_actions_in_episode,
                "max_queue": self.fleet.max_queue,
                "base_max_queue": self.base_max_queue,
                **({"class_queue_caps":
                    {name: self._class_cap(name)
                     for name in self._qos.classes}}
                   if self._qos_active else {}),
                "healthy_ticks": self._healthy_ticks,
                "last_signal": dict(self.last_signal),
                "fleet_mttr": self.fleet.mttr()}

    def record(self, **extra) -> Dict[str, Any]:
        """The serving-side ``kind: recovery`` record (fleet MTTR and
        the admission bound ride along as role extras)."""
        return self.log.record(
            max_queue=self.fleet.max_queue,
            base_max_queue=self.base_max_queue,
            fleet_mttr=self.fleet.mttr(), **extra)
