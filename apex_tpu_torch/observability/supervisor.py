"""Training-run supervisor: a host-side health verdict for live runs.

Counterpart of ``apex_tpu/observability/supervisor.py``, copied: it is
host-side Python over values the run already fetched.  A long training
run gets sick in ways no single metric names: a silent stall, a loss
spike or NaN, throughput decaying against its own history, one replica
drifting away from the others.  Every signal needed to detect these
reaches the host at existing flush points — the flushed
:class:`~.metrics.DeviceMetrics` / :class:`~.numerics.NumericsMonitor`
state, the per-step wall clock, ``ddp.last_comm_stats``, the
``checkpoint_saved`` flight-ring events — so the supervisor adds no
device traffic, no collective and nothing else to a training step.
:meth:`RunSupervisor.wrap_step` returns the step function *unchanged*:
there is nothing to turn off *in* the step, and a captured step with a
supervisor attached is the same graph as one without.

Detectors (each fires once per EPISODE — on the transition into the
sick state — with the flight ring carrying the event and a registry
counter carrying the volume):

- **stall** — the progress watermark (the ``step`` counter observed at
  flush, advanced also by ``checkpoint_saved`` flight events) has not
  moved for ``stall_observations`` consecutive observations;
- **loss_spike** — a finite loss exceeding ``loss_spike_factor`` × the
  warm loss EWMA;
- **nan** — a nonfinite loss, or a flushed numerics summary showing new
  overflow steps (the anomaly then names the culprit layer);
- **throughput_regression** — step time exceeding
  ``throughput_regression_factor`` × the warm step-time EWMA;
- **replica_divergence** — a flushed numerics divergence digest whose
  ``desync_steps`` advanced (the anomaly carries ``worst_leaf`` and
  ``max_rel_dev``);
- **recompilation_storm** — repeated signature-change retraces of one
  entry within a bounded observation window, fed by ``xla_retrace``
  flight-ring events, which the compilation ledger
  (``observability.compilation``) appends for every signature-change
  retrace: a refused batch shape of a captured step, an instrumented
  function called at a new shape.

Outputs: flight-ring events (``run_stall`` / ``run_loss_spike`` /
``run_nan`` / ``run_throughput_regression`` /
``run_replica_divergence`` / ``run_recompilation_storm``), registry
metrics (``run_anomalies_total{kind=...}``, loss / step-time EWMAs, the
watermark gauge), ``kind: run`` JSONL records (:meth:`record`, pinned by
``exporters.validate_run_record``), a ``/statusz``-ready :meth:`status`
dict with a ``health_check``, and the end-of-run :meth:`write_report`
artifact.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["ANOMALY_KINDS", "SupervisorConfig", "RunSupervisor"]

# every anomaly kind the supervisor can declare; validate_run_record
# rejects records naming anything else
ANOMALY_KINDS = ("stall", "loss_spike", "nan", "throughput_regression",
                 "replica_divergence", "recompilation_storm")


class SupervisorConfig:
    """Detector thresholds (all observation-counted, so the whole
    timeline is deterministic under test clocks).

    - ``stall_observations``: consecutive observations without a
      progress-watermark advance before the stall fires;
    - ``warmup_observations``: samples the loss / step-time EWMAs must
      absorb before spike / regression detection arms (a cold EWMA
      compares against noise);
    - ``loss_spike_factor`` / ``loss_alpha``: a finite loss above
      ``factor × ewma`` is a spike; ``alpha`` is the EWMA's newest-
      sample weight;
    - ``throughput_regression_factor`` / ``step_time_alpha``: same
      shape for the per-observation step time (higher = slower =
      regressed);
    - ``storm_retraces`` / ``storm_window_observations``: at least
      ``storm_retraces`` signature-change retraces of ONE jit entry
      (``xla_retrace`` flight events from the compilation ledger)
      within the last ``storm_window_observations`` observations
      declare a recompilation storm for that entry;
    - ``max_anomalies``: bound on the retained anomaly *detail* list
      (the counts are exact forever; a weeks-long sick run keeps the
      most recent details, flight-ring discipline).
    """

    def __init__(self, stall_observations: int = 10,
                 warmup_observations: int = 5,
                 loss_spike_factor: float = 3.0,
                 loss_alpha: float = 0.2,
                 throughput_regression_factor: float = 1.5,
                 step_time_alpha: float = 0.2,
                 storm_retraces: int = 3,
                 storm_window_observations: int = 20,
                 max_anomalies: int = 256):
        if stall_observations < 1:
            raise ValueError(f"stall_observations must be >= 1, got "
                             f"{stall_observations}")
        if warmup_observations < 1:
            raise ValueError(f"warmup_observations must be >= 1, got "
                             f"{warmup_observations}")
        if loss_spike_factor <= 1.0:
            raise ValueError(f"loss_spike_factor must be > 1, got "
                             f"{loss_spike_factor}")
        if throughput_regression_factor <= 1.0:
            raise ValueError(f"throughput_regression_factor must be "
                             f"> 1, got {throughput_regression_factor}")
        for name, a in (("loss_alpha", loss_alpha),
                        ("step_time_alpha", step_time_alpha)):
            if not (0.0 < a <= 1.0):
                raise ValueError(f"{name} must be in (0, 1], got {a}")
        if storm_retraces < 1:
            raise ValueError(f"storm_retraces must be >= 1, got "
                             f"{storm_retraces}")
        if storm_window_observations < 1:
            raise ValueError(f"storm_window_observations must be >= 1, "
                             f"got {storm_window_observations}")
        if max_anomalies < 1:
            raise ValueError(f"max_anomalies must be >= 1, got "
                             f"{max_anomalies}")
        self.stall_observations = stall_observations
        self.warmup_observations = warmup_observations
        self.loss_spike_factor = loss_spike_factor
        self.loss_alpha = loss_alpha
        self.throughput_regression_factor = throughput_regression_factor
        self.step_time_alpha = step_time_alpha
        self.storm_retraces = storm_retraces
        self.storm_window_observations = storm_window_observations
        self.max_anomalies = max_anomalies


def _finite(x) -> bool:
    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError):
        return False


class RunSupervisor:
    """Consume one training run's host-visible signals; hold a verdict.

    ``observe_step`` is the one feed — call it at every existing flush
    point with whatever host values that point already produced::

        sup = RunSupervisor("resnet50_o2_ddp")
        step = sup.wrap_step(step)        # identity; audit-pinned
        for i in range(steps):
            state, loss_dev = step(state, batch)
            if i % flush_every == 0:               # existing cadence
                flushed = nm.flush(state[-1])      # existing fetch
                sup.observe_step(step=i, loss=float(loss_dev),
                                 step_time_s=dt, numerics=flushed,
                                 comm_stats=ddp.last_comm_stats)
        rec = sup.record()                 # kind: run JSONL payload
        sup.write_report(path)             # end-of-run artifact

    ``enabled=False`` is the hard off-switch: every method is a cheap
    no-op and :meth:`wrap_step` still returns the step unchanged —
    there is nothing to turn off *in* the step, which is the point.
    ``ring``/``registry`` default to the process singletons resolved
    per use (the ``flightrec.resolve`` rule every producer follows).
    """

    def __init__(self, run: str = "run",
                 config: Optional[SupervisorConfig] = None,
                 registry=None, ring=None,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True):
        if not run:
            raise ValueError("run name must be non-empty")
        self.run = str(run)
        self.config = config or SupervisorConfig()
        self.registry = registry
        self._ring = ring
        self._clock = clock
        self.enabled = bool(enabled)
        self._t0 = clock()
        self._observations = 0
        self._loss_samples = 0
        self._time_samples = 0
        self._last_loss: Optional[float] = None
        self._loss_ewma: Optional[float] = None
        self._last_step_time: Optional[float] = None
        self._time_ewma: Optional[float] = None
        self._watermark: Optional[int] = None
        self._watermark_obs = 0          # observation of last advance
        self._tokens = 0
        self._counts: Dict[str, int] = {k: 0 for k in ANOMALY_KINDS}
        self._anomalies: deque = deque(
            maxlen=self.config.max_anomalies)
        # episode latches: fire on the TRANSITION into a sick state,
        # not once per observation spent in it (shed-episode rule —
        # a loss that goes NaN and STAYS NaN is one event, not one
        # per step wheeling the bounded ring past the history a
        # post-mortem needs)
        self._in_stall = False
        self._in_spike = False
        self._in_regression = False
        self._in_nan = False
        # deltas against the last consumed numerics flush / ring scan.
        # The ring watermark starts at the CURRENT total: a supervisor
        # attached to the process ring mid-life must not count a
        # previous run's checkpoint_saved events as its own progress
        # (the per-monitor flush-delta discipline record_scaler uses)
        self._last_desync = 0
        self._last_overflow = 0
        self._ring_seq_seen = self.ring.total
        self._ckpt_count = 0
        self._ckpt_step: Optional[int] = None
        # recompilation-storm feed: per-entry log of consumed
        # ``xla_retrace`` flight events, stamped with the observation
        # that consumed them so the window is observation-counted like
        # every other detector (bounded per entry, ring discipline)
        self._retrace_log: Dict[str, deque] = {}
        self._retrace_total = 0
        self._in_storm: set = set()
        self._scaler: Dict[str, Any] = {}
        self._comm: Dict[str, Any] = {}
        # recovery-in-flight (PR 11): set by the recovery controller
        # around an intentional rollback / world shrink — /healthz
        # reports the distinct degraded-but-live "recovering" state
        # instead of 503ing an orchestrator into a restart loop while
        # the run is being handled
        self._recovering: Optional[str] = None
        self._recoveries = 0
        # preemption (PR 12): set by the elastic trainer when a
        # PreemptionGuard request was honored — a CLEAN, live exit
        # (snapshot written, resume point named), not a sick state
        self._preempted: Optional[str] = None
        self._preempted_step: Optional[int] = None

    # -- the audit contract -------------------------------------------------
    def wrap_step(self, step_fn):
        """Return ``step_fn`` UNCHANGED.  The supervisor reads host
        values at existing flush points; it never instruments the
        step, so a captured step is the same graph with or without
        it, enabled or not."""
        return step_fn

    @property
    def ring(self):
        from . import flightrec
        return flightrec.resolve(self._ring)

    def _reg(self):
        from .metrics import get_registry
        return self.registry if self.registry is not None \
            else get_registry()

    # -- anomaly plumbing ---------------------------------------------------
    def _anomaly(self, kind: str, **detail) -> Dict[str, Any]:
        ev = {"kind": kind, "observation": self._observations,
              "step": self._watermark, "t_s": round(
                  self._clock() - self._t0, 6)}
        ev.update({k: v for k, v in detail.items() if v is not None})
        self._counts[kind] += 1
        self._anomalies.append(ev)
        self.ring.append(f"run_{kind}", run=self.run,
                         **{k: v for k, v in ev.items()
                            if k != "kind"})
        self._reg().counter(
            "run_anomalies_total",
            help="training-run anomalies detected by the supervisor"
        ).labels(kind=kind, run=self.run).inc()
        return ev

    def _consume_ring(self) -> bool:
        """Consume the supervisor's flight-ring feeds in one snapshot:
        ``checkpoint_saved`` events (the other progress feeder — a run
        writing checkpoints is making durable progress even when the
        caller has no step counter to report; only these affect the
        returned ``progressed`` bool) and ``xla_retrace`` events (the
        compilation ledger's signature-change retraces, stamped with
        the consuming observation into the per-entry log the
        recompilation-storm detector reads).  The cheap total==seen
        guard skips the snapshot copy on the (typical) quiet step, and
        the watermark advances only past what the snapshot actually
        contained — an event appended concurrently with the scan is
        consumed on the next one, never skipped."""
        ring = self.ring
        seen = self._ring_seq_seen
        if ring.total <= seen:
            return False
        snap = ring.snapshot()
        if snap:
            self._ring_seq_seen = snap[-1]["seq"] + 1
        fresh = [ev for ev in snap if ev["seq"] >= seen]
        # the compilation ledger's signature-change retraces feed the
        # recompilation-storm detector; stamped with THIS observation
        # so the storm window stays observation-counted
        for ev in fresh:
            if ev["kind"] != "xla_retrace":
                continue
            entry = str(ev.get("entry") or "?")
            log = self._retrace_log.get(entry)
            if log is None:
                # retained bound sized to the threshold: a config with
                # storm_retraces > 64 must still be able to accumulate
                # enough events to fire (the count would otherwise cap
                # below the threshold and the detector silently never
                # trip)
                log = self._retrace_log[entry] = deque(
                    maxlen=max(64, self.config.storm_retraces))
            log.append({"observation": self._observations,
                        "cause": ev.get("cause"),
                        "culprit": ev.get("culprit"),
                        "before": ev.get("before"),
                        "after": ev.get("after")})
            self._retrace_total += 1
        new = [ev for ev in fresh if ev["kind"] == "checkpoint_saved"]
        if not new:
            return False
        self._ckpt_count += len(new)
        steps = [ev.get("step") for ev in new
                 if isinstance(ev.get("step"), int)]
        if steps:
            self._ckpt_step = max(steps)
        return True

    # -- the feed -----------------------------------------------------------
    def observe_step(self, step: Optional[int] = None,
                     loss: Optional[float] = None,
                     step_time_s: Optional[float] = None,
                     tokens: Optional[int] = None,
                     numerics: Optional[Dict[str, Any]] = None,
                     comm_stats: Optional[List[dict]] = None
                     ) -> List[Dict[str, Any]]:
        """Fold one flush point's host-visible signals; returns the
        anomalies detected BY this observation (empty list = healthy).

        ``step`` is the run's progress counter (a flushed device
        ``steps`` total or the loop index); ``numerics`` is a flushed
        :class:`~.numerics.NumericsMonitor` summary; ``comm_stats`` is
        ``ddp.last_comm_stats``.  All inputs are plain host values the
        caller already holds — passing them here costs no device
        traffic."""
        if not self.enabled:
            return []
        cfg = self.config
        self._observations += 1
        found: List[Dict[str, Any]] = []

        # progress watermark: the step counter, plus checkpoint_saved
        # flight events (a checkpoint is durable progress)
        progressed = self._consume_ring()
        if step is not None:
            step = int(step)
            if self._watermark is None or step > self._watermark:
                self._watermark = step
                progressed = True
        if tokens is not None:
            self._tokens += int(tokens)
        if progressed:
            self._watermark_obs = self._observations
            self._in_stall = False
        elif (not self._in_stall
              and self._observations - self._watermark_obs
              >= cfg.stall_observations):
            self._in_stall = True
            found.append(self._anomaly(
                "stall",
                observations_without_progress=(
                    self._observations - self._watermark_obs),
                watermark=self._watermark))

        # recompilation storm: >= storm_retraces signature-change
        # retraces of ONE entry inside the observation window.  Fires
        # on the transition per entry (episode rule); the verdict
        # detail carries the retrace-cause differ's culprit signature
        # so /statusz names WHICH argument keeps changing.
        floor = self._observations - cfg.storm_window_observations
        for entry, log in self._retrace_log.items():
            recent = [ev for ev in log if ev["observation"] > floor]
            if len(recent) >= cfg.storm_retraces:
                if entry not in self._in_storm:
                    self._in_storm.add(entry)
                    last = recent[-1]
                    found.append(self._anomaly(
                        "recompilation_storm", entry=entry,
                        retraces_in_window=len(recent),
                        window_observations=(
                            cfg.storm_window_observations),
                        cause=last.get("cause"),
                        culprit=last.get("culprit"),
                        before=last.get("before"),
                        after=last.get("after")))
            else:
                self._in_storm.discard(entry)

        # loss: NaN/inf is an immediate anomaly — fired on the
        # TRANSITION into nonfinite (a loss that stays NaN is one
        # episode, not one ring event per step); a finite loss spikes
        # against the warm EWMA.  Anomalous samples never feed the
        # EWMA — the baseline must not chase the pathology.
        if loss is not None:
            if not _finite(loss):
                self._last_loss = None
                if not self._in_nan:
                    self._in_nan = True
                    found.append(self._anomaly(
                        "nan", loss=repr(loss), source="loss"))
            else:
                self._in_nan = False
                loss = float(loss)
                self._last_loss = loss
                warm = self._loss_samples >= cfg.warmup_observations
                if (warm and self._loss_ewma is not None
                        and self._loss_ewma > 0
                        and loss > cfg.loss_spike_factor
                        * self._loss_ewma):
                    if not self._in_spike:
                        self._in_spike = True
                        found.append(self._anomaly(
                            "loss_spike", loss=round(loss, 6),
                            ewma=round(self._loss_ewma, 6),
                            factor=round(loss / self._loss_ewma, 3)))
                else:
                    self._in_spike = False
                    self._loss_samples += 1
                    a = cfg.loss_alpha
                    self._loss_ewma = (loss if self._loss_ewma is None
                                       else a * loss
                                       + (1 - a) * self._loss_ewma)

        # step time: higher = slower = regressed
        if step_time_s is not None and _finite(step_time_s):
            dt = float(step_time_s)
            self._last_step_time = dt
            warm = self._time_samples >= cfg.warmup_observations
            if (warm and self._time_ewma is not None
                    and self._time_ewma > 0
                    and dt > cfg.throughput_regression_factor
                    * self._time_ewma):
                if not self._in_regression:
                    self._in_regression = True
                    found.append(self._anomaly(
                        "throughput_regression",
                        step_time_ms=round(dt * 1e3, 4),
                        ewma_ms=round(self._time_ewma * 1e3, 4),
                        factor=round(dt / self._time_ewma, 3)))
            else:
                self._in_regression = False
                self._time_samples += 1
                a = cfg.step_time_alpha
                self._time_ewma = (dt if self._time_ewma is None
                                   else a * dt
                                   + (1 - a) * self._time_ewma)

        # numerics flush: new overflow steps are a NaN-class anomaly
        # (with the culprit layer attribution riding along); a
        # divergence digest whose desync counter advanced is a
        # replica-divergence anomaly naming the worst leaf
        if numerics:
            ov = int(numerics.get("overflow_steps", 0) or 0)
            if ov > self._last_overflow:
                found.append(self._anomaly(
                    "nan", source="numerics",
                    overflow_steps=ov,
                    new_overflows=ov - self._last_overflow,
                    culprit=numerics.get("culprit"),
                    culprit_nonfinite=numerics.get(
                        "culprit_nonfinite"),
                    loss_scale=numerics.get("loss_scale")))
                self._last_overflow = ov
            div = numerics.get("divergence")
            if div:
                ds = int(div.get("desync_steps", 0) or 0)
                if ds > self._last_desync:
                    found.append(self._anomaly(
                        "replica_divergence",
                        desync_steps=ds,
                        new_desyncs=ds - self._last_desync,
                        max_rel_dev=div.get("max_rel_dev"),
                        worst_leaf=div.get("worst_leaf")))
                    self._last_desync = ds

        if comm_stats is not None:
            self._comm = {
                "buckets": len(comm_stats),
                "wire_bytes": sum(int(b.get("wire_bytes",
                                            b.get("bytes", 0)))
                                  for b in comm_stats)}

        self._fold_registry()
        return found

    def observe_scaler(self, stats: Dict[str, Any]):
        """amp tap (``amp.record_scaler(..., supervisor=sup)``): the
        scaler's loss scale / skip totals land on the status page next
        to the run verdict."""
        if not self.enabled:
            return
        self._scaler = {"loss_scale": stats.get("loss_scale"),
                        "steps_skipped": stats.get("steps_skipped")}

    def _fold_registry(self):
        reg = self._reg()
        if self._watermark is not None:
            reg.gauge("run_progress_watermark",
                      help="last observed training-run progress step"
                      ).labels(run=self.run).set(float(self._watermark))
        if self._loss_ewma is not None:
            reg.gauge("run_loss_ewma").labels(run=self.run).set(
                self._loss_ewma)
        if self._time_ewma is not None:
            reg.gauge("run_step_time_ewma_seconds").labels(
                run=self.run).set(self._time_ewma)

    # -- verdict / outputs --------------------------------------------------
    @property
    def anomaly_total(self) -> int:
        return sum(self._counts.values())

    @property
    def verdict(self) -> str:
        """``ok`` while no anomaly has fired, ``attention`` after."""
        return "ok" if self.anomaly_total == 0 else "attention"

    def begin_recovery(self, reason: str = ""):
        """A recovery controller is actively handling the run
        (rollback-restore, world shrink): ``health_check`` reports the
        distinct degraded-but-live ``recovering`` state until
        :meth:`end_recovery` — a /healthz 503 mid-shrink would flap an
        orchestrator into a restart loop on a run that is already
        being fixed."""
        self._recovering = str(reason) or "recovery in flight"
        self._recoveries += 1
        self.ring.append("run_recovery_begin", run=self.run,
                         reason=self._recovering)

    def end_recovery(self):
        if self._recovering is not None:
            self.ring.append("run_recovery_end", run=self.run)
        self._recovering = None

    def rewind(self, step: int):
        """The run legitimately REWOUND (a recovery controller
        restored an earlier snapshot): reset the progress watermark to
        ``step`` and grant a fresh stall grace period.  Without this,
        a long replay below the old watermark (checkpoint cadence >
        stall_observations) would fire a spurious stall verdict on a
        perfectly healthy recovery — and, with stall in the
        controller's trigger set, a pointless second rollback."""
        if not self.enabled:
            return
        self._watermark = int(step)
        self._watermark_obs = self._observations
        self._in_stall = False
        self.ring.append("run_rewound", run=self.run, step=int(step))

    @property
    def recovering(self) -> bool:
        return self._recovering is not None

    def mark_preempted(self, step: Optional[int] = None,
                       reason: str = ""):
        """The run exited on a PREEMPTION notice after its coordinated
        emergency snapshot — a planned, clean exit whose resume point
        is the last durable snapshot.  ``/healthz`` stays live (the
        orchestrator is about to reschedule the job anyway; a 503
        would just add a restart-loop to the preemption) and
        ``/statusz`` says where the run stopped and why."""
        if not self.enabled:
            return
        self._preempted = str(reason) or "preempted"
        self._preempted_step = (int(step) if step is not None
                                else self._watermark)
        self.ring.append("run_preempted", run=self.run,
                         step=self._preempted_step,
                         reason=self._preempted)

    @property
    def preempted(self) -> bool:
        return self._preempted is not None

    def health_check(self):
        """``(ok, detail)`` for the introspection server's /healthz:
        unhealthy while the run sits IN a sick episode (stall not yet
        recovered, loss currently nonfinite); a past, RECOVERED
        anomaly degrades the verdict but not liveness — a routine
        amp-scaler overflow must not leave an orchestrator probe
        failing forever.  A recovery IN FLIGHT is degraded-but-LIVE:
        the sick state is being handled by a controller, and a 503
        would invite exactly the restart the recovery exists to
        avoid."""
        if self._preempted is not None:
            return True, (f"preempted: {self._preempted} (stopped at "
                          f"step {self._preempted_step}; resume from "
                          f"the last durable snapshot)")
        if self._recovering is not None:
            return True, (f"recovering: {self._recovering} "
                          f"(recovery {self._recoveries})")
        sick = []
        if self._in_stall:
            sick.append("stalled")
        if self._in_nan:
            sick.append(f"nan (x{self._counts['nan']} total)")
        if sick:
            return False, "; ".join(sick)
        return True, (f"verdict={self.verdict}, "
                      f"{self.anomaly_total} anomalies over "
                      f"{self._observations} observations")

    def status(self) -> Dict[str, Any]:
        """The ``/statusz`` snapshot (plain python, cheap)."""
        out = {
            "run": self.run, "enabled": self.enabled,
            "verdict": self.verdict,
            "observations": self._observations,
            "watermark": self._watermark,
            "observations_since_progress": (
                self._observations - self._watermark_obs),
            "stalled": self._in_stall,
            "loss_nonfinite": self._in_nan,
            "recovering": self._recovering,
            "recoveries": self._recoveries,
            "preempted": self._preempted,
            "preempted_step": self._preempted_step,
            "anomaly_counts": dict(self._counts),
            "anomaly_total": self.anomaly_total,
            "recompilation": {
                "retrace_events": self._retrace_total,
                "entries_in_storm": sorted(self._in_storm)},
            "loss": {"last": self._last_loss,
                     "ewma": self._loss_ewma},
            "step_time_s": {"last": self._last_step_time,
                            "ewma": self._time_ewma},
            "tokens": self._tokens,
            "checkpoint": {"count": self._ckpt_count,
                           "last_step": self._ckpt_step},
            "uptime_s": round(self._clock() - self._t0, 3),
        }
        if self._scaler:
            out["scaler"] = dict(self._scaler)
        if self._comm:
            out["comm"] = dict(self._comm)
        return out

    def record(self, metric: Optional[str] = None,
               **extra) -> Dict[str, Any]:
        """One schema-v5 ``kind: run`` JSONL payload (enrich through
        ``JsonlExporter``; ``exporters.validate_run_record`` pins the
        shape)."""
        rec: Dict[str, Any] = {
            "kind": "run", "run": self.run,
            "verdict": self.verdict,
            "observations": self._observations,
            "watermark": self._watermark,
            "anomaly_counts": dict(self._counts),
            "anomalies": [dict(a) for a in self._anomalies],
            "loss": {"last": self._last_loss, "ewma": self._loss_ewma},
            "step_time_s": {"last": self._last_step_time,
                            "ewma": self._time_ewma},
            "checkpoints": self._ckpt_count,
            "duration_s": round(self._clock() - self._t0, 6),
        }
        if metric:
            rec["metric"] = metric
        rec.update(extra)
        return rec

    def report(self) -> Dict[str, Any]:
        """End-of-run report: the run record plus the full status
        snapshot — what :meth:`write_report` persists."""
        return {"record": self.record(), "status": self.status()}

    def write_report(self, path: str) -> str:
        """Write the end-of-run report artifact (atomic replace, the
        flight-ring dump discipline)."""
        rep = self.report()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rep, f, indent=2, default=repr)
            f.write("\n")
        os.replace(tmp, path)
        return path
