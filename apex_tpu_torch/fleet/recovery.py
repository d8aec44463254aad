"""The telemetry→action loop's shared pieces, and its training side.

Counterpart of ``apex_tpu/fleet/recovery.py``, its stdlib and numpy code
copied:

- :class:`RecoveryLog`, the episode / action / MTTR bookkeeping that
  both directions of the loop share — the serving-side controller
  (:mod:`apex_tpu_torch.fleet.autoscale`) writes its ``kind: recovery``
  records through it (``observability.exporters.
  validate_recovery_record``);
- the ``RECOVERY_*`` vocabularies (duplicated in
  ``observability.exporters``; a test pins the copies equal);
- :class:`PreemptionGuard`, which turns SIGTERM (or a programmatic
  :meth:`~PreemptionGuard.preempt`) into a request a trainer honors at
  its next step boundary;
- :func:`reshard_flat_state`, the ZeRO flat-shard redistribution onto a
  resized world, over a nested dict / list / tuple of numpy arrays or
  torch tensors.

The elastic trainer (:class:`ElasticTrainer`, :class:`ElasticConfig`:
shrink the data-parallel world over the survivors of a replica death,
redistribute ZeRO shards, resume from the last durable snapshot) is not
ported yet: it feeds the run supervisor, and both are ROADMAP.md queue
1 item 8b.  Both names raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


__all__ = ["RECOVERY_ROLES", "RECOVERY_ACTION_KINDS", "RECOVERY_CAUSES",
           "RecoveryError", "RecoveryLog", "PreemptionGuard",
           "ElasticConfig", "ElasticTrainer", "reshard_flat_state"]

# both directions of the telemetry→action loop emit the same
# ``kind: recovery`` record; ``role`` says which controller wrote it
RECOVERY_ROLES = ("training", "serving")

# every action a controller may take (exporters.validate_recovery_record
# rejects records naming anything else; a test pins the two tuples
# equal, the RUN_ANOMALY_KINDS discipline):
# training — world_shrink (drop dead replicas from the data axis),
#   resume (restore the last durable snapshot + re-jit), rollback
#   (verdict-triggered restore at the SAME world), preempt_snapshot
#   (the coordinated emergency snapshot a preemption notice triggers
#   at the next step boundary, within the grace budget);
# serving — admission_tighten/relax (the fleet's bounded-queue knob),
#   class_admission_tighten/relax (the same knob scoped to ONE
#   QoS class's queue quota — tighten the lowest-priority class first,
#   never rank 0, so interactive admission survives a batch flood),
#   window_shrink/grow (decode window on replicas that support it),
#   drain/undrain (capacity out/in), cooldown_shorten/extend (the
#   breaker's step-counted cooldowns).
RECOVERY_ACTION_KINDS = (
    "world_shrink", "resume", "rollback", "preempt_snapshot",
    "admission_tighten", "admission_relax",
    "class_admission_tighten", "class_admission_relax",
    "window_shrink", "window_grow",
    "drain", "undrain",
    "cooldown_shorten", "cooldown_extend")

# why a recovery/exit happened, when a record says (schema v7):
# fault = an injected/real replica death, verdict = a supervisor
# anomaly triggered the rollback, preemption = a planned SIGTERM /
# maintenance notice honored at a step boundary.  Duplicated
# stdlib-side in observability.exporters (tuple-pinned by a test).
RECOVERY_CAUSES = ("fault", "verdict", "preemption")


class RecoveryError(RuntimeError):
    """Recovery itself failed (no survivors to shrink onto, no durable
    snapshot, recovery budget exhausted) — the point where a human IS
    needed and a loud failure beats a silent loop."""


class RecoveryLog:
    """Episode / action / MTTR bookkeeping shared by both controllers.

    An EPISODE opens on the transition into a sick state (fault caught,
    SLO breached) and closes when the controller declares the system
    recovered; every actuation lands as an ACTION inside the current
    episode.  Actions are bounded per episode by the caller's config —
    the anti-oscillation contract ``tests/ci/chaos_smoke.py`` gates —
    and the retained detail list is bounded like the supervisor's
    anomaly list (counts exact forever, details flight-ring
    discipline).  MTTR is fault-to-first-good-step, fed by the caller
    at the instants it owns."""

    def __init__(self, role: str, subject: str,
                 clock: Callable[[], float] = time.perf_counter,
                 max_actions: int = 256, ring=None, registry=None):
        if role not in RECOVERY_ROLES:
            raise ValueError(f"role must be one of {RECOVERY_ROLES}, "
                             f"got {role!r}")
        if not subject:
            raise ValueError("subject must be non-empty")
        self.role = role
        self.subject = str(subject)
        self._clock = clock
        self._t0 = clock()
        self._ring = ring
        self.registry = registry
        self.episodes = 0
        self.actions_total = 0
        self.max_actions_in_episode = 0
        self._actions_this_episode = 0
        self._episode_open = False
        self._episode_t0: Optional[float] = None
        self._actions: deque = deque(maxlen=max_actions)
        self._mttr_count = 0
        self._mttr_sum = 0.0
        self._mttr_last: Optional[float] = None

    @property
    def ring(self):
        from ..observability import flightrec
        return flightrec.resolve(self._ring)

    def _reg(self):
        from ..observability.metrics import get_registry
        return self.registry if self.registry is not None \
            else get_registry()

    @property
    def in_flight(self) -> bool:
        return self._episode_open

    @property
    def actions_this_episode(self) -> int:
        return self._actions_this_episode

    def open_episode(self, reason: str, **attrs):
        """Transition into a sick state (idempotent while open)."""
        if self._episode_open:
            return
        self._episode_open = True
        self.episodes += 1
        self._actions_this_episode = 0
        self._episode_t0 = self._clock()
        self.ring.append("recovery_started", role=self.role,
                         subject=self.subject, reason=reason,
                         episode=self.episodes, **attrs)
        self._reg().counter(
            "recovery_episodes_total",
            help="telemetry→action recovery episodes opened"
        ).labels(role=self.role).inc()

    def action(self, kind: str, **detail) -> Dict[str, Any]:
        """One actuation inside the current episode."""
        if kind not in RECOVERY_ACTION_KINDS:
            raise ValueError(f"unknown recovery action {kind!r} "
                             f"(known: {RECOVERY_ACTION_KINDS})")
        t = self._clock() - self._t0
        if t < 0:
            # catch the gotcha AT THE SOURCE: a negative offset
            # means this log's t0 predates the current clock reading —
            # the fleet/controller/trainer was constructed BEFORE an
            # injected tick clock was reset.  Failing here, with the
            # remedy, beats the validator rejecting the finished
            # record later in validate_recovery_record.
            raise ValueError(
                f"RecoveryLog t_s went negative ({t:.6f}s): the log "
                f"was constructed before its clock was reset (an "
                f"injected tick clock rewound past the log's t0). "
                f"Reset the clock FIRST, then build the fleet and "
                f"controller/trainer — the bench --chaos drive() "
                f"precondition.")
        # an action before ANY episode (e.g. a relax correcting a
        # mis-tuned construction) carries episode=None — stamping a
        # phantom episode 1 into a record declaring zero episodes
        # would fail its own validator
        ev = {"kind": kind,
              "episode": self.episodes if self.episodes else None,
              "t_s": round(t, 6)}
        ev.update({k: v for k, v in detail.items() if v is not None})
        self.actions_total += 1
        if self._episode_open:
            # only in-episode actuation counts toward the per-episode
            # oscillation bound — the relax actions a controller takes
            # AFTER declaring recovery are the unwinding, not the
            # thrashing the bound exists to catch
            self._actions_this_episode += 1
            self.max_actions_in_episode = max(
                self.max_actions_in_episode,
                self._actions_this_episode)
        self._actions.append(ev)
        self.ring.append("recovery_action", role=self.role,
                         subject=self.subject,
                         **{("action" if k == "kind" else k): v
                            for k, v in ev.items()})
        self._reg().counter(
            "recovery_actions_total",
            help="recovery-controller actuations by kind"
        ).labels(role=self.role, kind=kind).inc()
        return ev

    def close_episode(self, mttr_s: Optional[float] = None, **attrs):
        """The system recovered; ``mttr_s`` is fault-to-first-good-step
        when the caller measured one."""
        if not self._episode_open:
            return
        self._episode_open = False
        if mttr_s is not None:
            mttr_s = float(mttr_s)
            self._mttr_count += 1
            self._mttr_sum += mttr_s
            self._mttr_last = mttr_s
            self._reg().histogram(
                "recovery_mttr_seconds",
                help="fault injection to first post-recovery step"
            ).observe(mttr_s)
        self.ring.append("recovery_done", role=self.role,
                         subject=self.subject, episode=self.episodes,
                         actions=self._actions_this_episode,
                         mttr_s=(round(mttr_s, 6)
                                 if mttr_s is not None else None),
                         **attrs)

    def mttr(self) -> Dict[str, Any]:
        return {"last": self._mttr_last,
                "mean": (self._mttr_sum / self._mttr_count
                         if self._mttr_count else None),
                "count": self._mttr_count}

    def record(self, **extra) -> Dict[str, Any]:
        """One ``kind: recovery`` JSONL payload (enrich through
        ``JsonlExporter``; ``exporters.validate_recovery_record`` pins
        the shape)."""
        rec: Dict[str, Any] = {
            "kind": "recovery", "role": self.role,
            "subject": self.subject,
            "episodes": self.episodes,
            "actions_total": self.actions_total,
            "max_actions_in_episode": self.max_actions_in_episode,
            "actions": [dict(a) for a in self._actions],
            "mttr_s": self.mttr(),
            "in_flight": self._episode_open,
            "duration_s": round(self._clock() - self._t0, 6),
        }
        rec.update(extra)
        return rec


class PreemptionGuard:
    """Turn a preemption notice into a step-boundary snapshot request.

    Real fleets preempt with SIGTERM plus a grace window;
    :meth:`install` registers a handler for it (restoring the previous
    handler on :meth:`uninstall` / context exit), and
    :meth:`preempt` is the programmatic entry point — what the handler
    calls, and what ``TrainingFaults(preemption=...)`` calls in tests.
    The guard never acts on its own: it records the request (first one
    wins, later ones are no-ops), stamps the grace clock, appends a
    ``preemption_requested`` flight-ring event and bumps
    ``preemptions_total``; the :class:`ElasticTrainer` polls
    :attr:`requested` at every step boundary and, with grace left,
    writes the coordinated emergency snapshot (tree + ``data_state``)
    before exiting with a ``preempted`` verdict — with the grace
    budget already exhausted it exits WITHOUT starting a write a
    torn-snapshot cleanup would have to mop up."""

    def __init__(self, grace_s: float = 30.0,
                 clock: Callable[[], float] = time.perf_counter,
                 ring=None, registry=None):
        if grace_s < 0:
            raise ValueError(f"grace_s must be >= 0, got {grace_s}")
        self.grace_s = float(grace_s)
        self._clock = clock
        self._ring = ring
        self.registry = registry
        self._reason: Optional[str] = None
        self._t0: Optional[float] = None
        self._installed: Dict[int, Any] = {}

    @property
    def ring(self):
        from ..observability import flightrec
        return flightrec.resolve(self._ring)

    def _reg(self):
        from ..observability.metrics import get_registry
        return self.registry if self.registry is not None \
            else get_registry()

    # -- the request --------------------------------------------------------
    def preempt(self, reason: str = "programmatic") -> None:
        """Request a coordinated shutdown (idempotent: the FIRST
        request starts the grace clock; repeats are no-ops)."""
        if self._reason is not None:
            return
        self._reason = str(reason) or "programmatic"
        self._t0 = self._clock()
        self.ring.append("preemption_requested", reason=self._reason,
                         grace_s=self.grace_s)
        self._reg().counter(
            "preemptions_total",
            help="preemption notices received (signal or programmatic)"
        ).inc()

    @property
    def requested(self) -> bool:
        return self._reason is not None

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    @property
    def requested_at(self) -> Optional[float]:
        """Clock reading of the first :meth:`preempt` call (the MTTR
        window's left edge), ``None`` before any request."""
        return self._t0

    def grace_remaining(self) -> float:
        """Seconds of grace budget left (the full budget before any
        request; clamped at 0)."""
        if self._t0 is None:
            return self.grace_s
        return max(0.0, self.grace_s - (self._clock() - self._t0))

    def reset(self) -> None:
        """Clear the request (a resumed test harness reusing one
        guard; production resumes build a fresh process anyway)."""
        self._reason = None
        self._t0 = None

    # -- the signal surface -------------------------------------------------
    def _handle(self, signum, frame):
        self.preempt(f"signal {signum}")

    def install(self, signals=None) -> "PreemptionGuard":
        """Register the handler (default: SIGTERM — what a scheduler's
        maintenance/preemption sends); previous handlers are kept and
        restored by :meth:`uninstall`.  Main-thread only, per the
        stdlib signal contract."""
        import signal as _signal
        if signals is None:
            signals = (_signal.SIGTERM,)
        for s in signals:
            if s in self._installed:
                # already ours: re-installing would record OUR handler
                # as "previous" and uninstall could never restore the
                # original one
                continue
            self._installed[s] = _signal.signal(s, self._handle)
        return self

    def uninstall(self) -> None:
        import signal as _signal
        for s, prev in self._installed.items():
            _signal.signal(s, prev)
        self._installed = {}

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def reshard_flat_state(tree: Any, total: int, old_world: int,
                       new_world: int) -> Any:
    """Redistribute ZeRO flat optimizer shards onto a resized world.

    The flat-buffer ZeRO state (``amp.zero_optimizer_specs``) pads
    every 1-D shard buffer — fp32 masters and the elementwise inner
    optimizer's moment buffers — to a multiple of the shard population
    so the device-concat global splits evenly.  ``total`` is the
    logical (unpadded) element count
    (``opt_state.masters.layout.total``); every 1-D leaf of exactly
    the old padded length is sliced back to ``total`` and
    zero-re-padded for the new population.  Scalars and non-flat
    leaves pass through unchanged.  A numpy leaf comes back a numpy
    array (host math, as in the JAX package); a tensor leaf comes back
    a tensor on its own device.

    ``old_world`` / ``new_world`` are the shard POPULATIONS, which is
    what the buffers were padded for: the full axis size for ZeRO-1,
    the ICI slice size (``layout.zero_ici``) for ZeRO-2/3 — an 8->4
    world shrink at ici 4->2 resharding stage-2/3 state passes (4, 2)
    here while the ZeRO-1 leg of the same shrink passes (8, 4).  The
    math is identical: stage 2/3 state is replicated across slices, so
    redistributing one slice's padding redistributes them all."""
    if old_world < 1 or new_world < 1:
        raise ValueError(f"world sizes must be >= 1, got {old_world} "
                         f"and {new_world}")
    old_pad = total + (-total) % old_world
    new_pad = total + (-total) % new_world

    def fix(leaf):
        if isinstance(leaf, torch.Tensor):
            # a tensor stays a tensor, on its own device
            if leaf.dim() == 1 and leaf.shape[0] == old_pad:
                return torch.nn.functional.pad(leaf[:total],
                                               (0, new_pad - total))
            return leaf
        arr = np.asarray(leaf)
        if arr.ndim == 1 and arr.shape[0] == old_pad:
            return np.pad(arr[:total], (0, new_pad - total))
        return arr

    return _tree_map(fix, tree)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (the
    containers of a state tree; ``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if tree is None:
        return None
    return fn(tree)


_ITEM8B = ("is not ported yet: the elastic trainer and the run "
           "supervisor it feeds are ROADMAP.md queue 1 item 8b")


class ElasticConfig:
    """Recovery policy knobs of the elastic trainer (not ported yet:
    ROADMAP.md queue 1 item 8b)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ElasticConfig {_ITEM8B}")


class ElasticTrainer:
    """Elastic data-parallel run harness (not ported yet: ROADMAP.md
    queue 1 item 8b, with ``observability.supervisor.RunSupervisor``;
    ``tests/test_recovery.py`` is its parity spec)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ElasticTrainer {_ITEM8B}")
