"""Seeded, deterministic fault injection around one replica.

:class:`FaultyReplica` wraps an ``Engine``/``Seq2SeqEngine`` (or
anything exposing the same surface) and misbehaves ON SCHEDULE: every
fault is a half-open step-count window ``(start, stop)`` over the
wrapper's own ``step()`` counter, so a test that says "the replica
dies at step 3" gets exactly that, every run.  An optional seeded
``p_error`` adds random step failures that are still deterministic per
seed — soak-style tests without flakiness.

Fault kinds (all composable):

- ``raise_on_step`` — ``step()`` raises :class:`ReplicaFault` BEFORE
  touching the wrapped engine, which therefore stays internally
  consistent (no half-donated buffers); this is the crash/failover
  fault the exactness tests lean on.
- ``raise_on_prefill`` — ``add_request``/``submit`` raise instead of
  admitting; exercises dispatch-retry.
- ``stall`` — ``step()`` returns ``{}`` without stepping the engine
  (optionally sleeping ``stall_s`` first): the hang that never raises.
  Only the fleet's no-progress watchdog can catch it.
- ``slow`` — ``step()`` sleeps ``slow_s`` then steps normally: correct
  results at degraded latency; feeds the latency EWMA.
- ``drop_results`` — the engine steps (state advances!) but the
  emitted tokens are swallowed.  The wrapped engine will still finish
  the requests internally; a fleet that relies on per-step emissions
  for liveness sees silence — watchdog territory again.

Everything else (``stats``, ``result``, ``cancel``, ``take_waiting``,
``free_slots``, …) proxies straight through, so a ``FaultyReplica`` is
a drop-in fleet member.

:class:`TrainingFaults` brings the same half-open
``[start, stop)`` step-window discipline to TRAINING-shaped failures —
replica death mid-step, torn/partial checkpoint writes, and
slow-straggler windows — for the elastic recovery harness
(``fleet.recovery.ElasticTrainer``).  Its windows count OBSERVED
steps (``check_step`` calls), which advance monotonically across
recoveries: a death armed at observed step 5 fires exactly once even
though the run, after resuming from an earlier snapshot, replays the
same *run*-step index again.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np

__all__ = ["ReplicaFault", "FaultyReplica", "TrainingFaults"]


class ReplicaFault(RuntimeError):
    """An injected failure (never raised by real engines)."""


def _windows(spec) -> Tuple[Tuple[int, Optional[int]], ...]:
    """Normalize a window spec: None/() = never; True = always;
    (start, stop) or a sequence of such pairs; stop None = forever."""
    if spec is None or spec == ():
        return ()
    if spec is True:
        return ((0, None),)
    if (isinstance(spec, (tuple, list)) and len(spec) == 2
            and all(isinstance(x, int) or x is None for x in spec)):
        return (tuple(spec),)
    return tuple(tuple(w) for w in spec)


def _in(windows, t: int) -> bool:
    return any(s <= t and (e is None or t < e) for s, e in windows)


def _arm_windows(obj, known, steps: int, relative: bool, kinds: dict):
    """Shared ``arm()`` body for both fault harnesses: validate the
    kind names, parse each window spec, rebase relative offsets onto
    the harness's current step counter, and store as ``_<kind>``."""
    unknown = set(kinds) - set(known)
    if unknown:
        raise TypeError(f"unknown fault kind(s) {sorted(unknown)}; "
                        f"known: {list(known)}")
    for kind in known:
        if kind not in kinds:
            continue
        ws = _windows(kinds[kind])
        if relative:
            ws = tuple((s + steps, None if e is None else e + steps)
                       for s, e in ws)
        setattr(obj, "_" + kind, ws)


class FaultyReplica:
    """Deterministic misbehaving proxy around ``replica``.

    All windows are half-open ``[start, stop)`` intervals of the
    wrapper's step counter (``stop=None`` = forever); ``p_error``
    raises on a seeded coin flip per step, on top of any windows."""

    def __init__(self, replica, *,
                 raise_on_step=(), raise_on_prefill=(), stall=(),
                 slow=(), drop_results=(),
                 slow_s: float = 0.05, stall_s: float = 0.0,
                 p_error: float = 0.0, seed: int = 0, ring=None):
        self._inner = replica
        self._raise_on_step = _windows(raise_on_step)
        self._raise_on_prefill = _windows(raise_on_prefill)
        self._stall = _windows(stall)
        self._slow = _windows(slow)
        self._drop_results = _windows(drop_results)
        self.slow_s = slow_s
        self.stall_s = stall_s
        self.p_error = p_error
        self._rng = np.random.RandomState(seed)
        self.steps = 0                  # step() calls observed
        self.faults_fired = 0
        # flight-recorder trail: every injected fault lands in the ring
        # (default: the CURRENT process ring, resolved per append so a
        # set_ring swap moves the whole story together), so a
        # post-mortem dump shows the injected cause right next to the
        # breaker/failover transitions it provoked
        self._ring = ring

    @property
    def ring(self):
        from ..observability import flightrec
        return flightrec.resolve(self._ring)

    def _fired(self, kind: str, step: int):
        self.faults_fired += 1
        self.ring.append("fault_injected", fault=kind, step=step)

    # -- faulted surface ---------------------------------------------------
    def step(self):
        t = self.steps
        self.steps += 1
        if _in(self._stall, t):
            self._fired("stall", t)
            if self.stall_s:
                time.sleep(self.stall_s)
            return {}
        if _in(self._raise_on_step, t):
            self._fired("raise_on_step", t)
            raise ReplicaFault(f"injected step fault at step {t}")
        if self.p_error > 0.0 and self._rng.uniform() < self.p_error:
            # label the probabilistic fault as what it is — a
            # post-mortem reading the ring must not conclude a
            # deterministic window was configured at this step
            self._fired("p_error", t)
            raise ReplicaFault(f"injected step fault at step {t}")
        if _in(self._slow, t):
            self._fired("slow", t)
            time.sleep(self.slow_s)
        out = self._inner.step()
        if _in(self._drop_results, t):
            self._fired("drop_results", t)
            return {}
        return out

    def _check_prefill_fault(self):
        if _in(self._raise_on_prefill, self.steps):
            self._fired("raise_on_prefill", self.steps)
            raise ReplicaFault(
                f"injected prefill fault at step {self.steps}")

    def add_request(self, *a, **kw):
        self._check_prefill_fault()
        return self._inner.add_request(*a, **kw)

    def submit(self, *a, **kw):
        self._check_prefill_fault()
        return self._inner.submit(*a, **kw)

    def arm(self, *, relative: bool = True, **kinds):
        """(Re)program fault windows at runtime.  With ``relative=True``
        (default) window offsets count from the CURRENT step counter —
        ``arm(raise_on_step=(6, None))`` means "die 6 steps from now",
        which is how a bench arms a mid-run death AFTER its warmup
        traffic (a constructor window would fire during warmup).
        Passing ``()`` clears a fault kind."""
        _arm_windows(self, ("raise_on_step", "raise_on_prefill",
                            "stall", "slow", "drop_results"),
                     self.steps, relative, kinds)

    # -- transparent proxy -------------------------------------------------
    def __getattr__(self, name):
        # only reached for names not defined on the wrapper: stats,
        # result, cancel, take_waiting, free_slots, is_finished,
        # register_prefix, slots, metrics, ...
        return getattr(self._inner, name)


class TrainingFaults:
    """Seeded, deterministic training-shaped fault schedule.

    The elastic run harness calls :meth:`check_step` once per
    *attempted* training step (after the device math, BEFORE the
    result is committed) and :meth:`after_checkpoint` once per
    snapshot save.  All windows are half-open ``[start, stop)``
    intervals over the schedule's own OBSERVED-step counter — the
    count of ``check_step`` calls, which is monotonic across
    recoveries — so fault timelines stay exact in tests even when the
    run replays run-step indices after resuming from a snapshot.

    Fault kinds:

    - ``replica_death`` — :meth:`check_step` raises
      :class:`ReplicaFault` before the step result commits, the
      mid-step crash the recovery controller shrinks the world for
      (the in-memory state the harness holds stays consistent; the
      device state is abandoned and recovery resumes from the last
      durable snapshot anyway);
    - ``torn_checkpoint`` — :meth:`after_checkpoint` truncates the
      just-written snapshot file to ``torn_fraction`` of its bytes
      (out-of-band corruption AFTER the atomic rename: the save-time
      ``checkpoint_saved`` event truthfully named a snapshot that
      verified; restore-time checksum verification is what catches
      the tear);
    - ``straggler`` — :meth:`check_step` sleeps ``straggle_s`` (the
      slow window that degrades throughput without failing anything —
      supervisor ``throughput_regression`` territory);
    - ``preemption`` — the PLANNED failure real fleets see most:
      a maintenance/preemption notice (SIGTERM with a grace window).
      :meth:`check_step` does not raise — it calls
      ``guard.preempt(...)`` on the attached
      :class:`~apex_tpu_torch.fleet.recovery.PreemptionGuard` (the same
      entry point the real SIGTERM handler uses), and the run exits
      with a ``preempted`` verdict at the next step boundary after a
      coordinated emergency snapshot;
    - ``p_death`` — seeded random deaths per observed step, on top of
      any windows (soak-style, deterministic per seed).

    Every injected fault lands a ``fault_injected`` flight-ring event
    (``FaultyReplica`` discipline), so a post-mortem dump shows the
    cause next to the recovery actions it provoked.
    """

    def __init__(self, *, replica_death=(), torn_checkpoint=(),
                 straggler=(), preemption=(),
                 straggle_s: float = 0.01,
                 torn_fraction: float = 0.6,
                 p_death: float = 0.0, seed: int = 0, ring=None,
                 guard=None):
        if not (0.0 < torn_fraction < 1.0):
            raise ValueError(f"torn_fraction must be in (0, 1), got "
                             f"{torn_fraction}")
        self._replica_death = _windows(replica_death)
        self._torn_checkpoint = _windows(torn_checkpoint)
        self._straggler = _windows(straggler)
        self._preemption = _windows(preemption)
        # the PreemptionGuard the preemption fault notifies (the
        # ElasticTrainer auto-wires its own guard here when the
        # harness left it unset)
        self.guard = guard
        self.straggle_s = straggle_s
        self.torn_fraction = torn_fraction
        self.p_death = p_death
        self._rng = np.random.RandomState(seed)
        self.steps = 0                   # check_step calls observed
        self.faults_fired = 0
        self.torn_paths: list = []
        self._ring = ring

    @property
    def ring(self):
        from ..observability import flightrec
        return flightrec.resolve(self._ring)

    def _fired(self, kind: str, step: int, **attrs):
        self.faults_fired += 1
        self.ring.append("fault_injected", fault=kind, step=step,
                         **attrs)

    def check_step(self, run_step: Optional[int] = None) -> None:
        """One observed training step: straggle if scheduled, then die
        if scheduled.  ``run_step`` (the run's own step index, which
        can repeat across recoveries) only annotates the ring event —
        the windows are over the observed counter."""
        t = self.steps
        self.steps += 1
        if _in(self._straggler, t):
            self._fired("straggler", t, run_step=run_step,
                        straggle_s=self.straggle_s)
            if self.straggle_s:
                time.sleep(self.straggle_s)
        if _in(self._preemption, t):
            # a planned preemption notice, not a crash: notify the
            # guard (idempotent) and keep stepping — the run exits at
            # its next step boundary after an emergency snapshot
            self._fired("preemption", t, run_step=run_step)
            if self.guard is not None:
                self.guard.preempt(
                    f"injected preemption at observed step {t}")
        if _in(self._replica_death, t):
            self._fired("replica_death", t, run_step=run_step)
            raise ReplicaFault(
                f"injected replica death at observed step {t}"
                + (f" (run step {run_step})"
                   if run_step is not None else ""))
        if self.p_death > 0.0 and self._rng.uniform() < self.p_death:
            self._fired("p_death", t, run_step=run_step)
            raise ReplicaFault(
                f"injected replica death (seeded) at observed step {t}")

    def after_checkpoint(self, path: str) -> bool:
        """Tear the snapshot at ``path`` if the CURRENT observed step
        sits in a torn window (truncate to ``torn_fraction`` of its
        bytes — a partial write frozen mid-flight).  Returns True when
        the file was torn."""
        # the window is evaluated at the observed step of the save,
        # i.e. the steps counter AFTER the step that triggered it
        t = self.steps
        if not _in(self._torn_checkpoint, t):
            return False
        size = os.path.getsize(path)
        keep = max(1, int(size * self.torn_fraction))
        with open(path, "rb+") as f:
            f.truncate(keep)
        self.torn_paths.append(path)
        self._fired("torn_checkpoint", t, path=path,
                    bytes_kept=keep, bytes_total=size)
        return True

    def arm(self, *, relative: bool = True, **kinds):
        """(Re)program fault windows at runtime, ``FaultyReplica.arm``
        semantics: with ``relative=True`` offsets count from the
        current observed step; ``()`` clears a kind."""
        _arm_windows(self, ("replica_death", "torn_checkpoint",
                            "straggler", "preemption"),
                     self.steps, relative, kinds)
