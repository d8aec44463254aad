"""Replica health: EWMA-driven states, circuit breaker, drain flags.

A replica is ``healthy``, ``degraded`` or ``dead`` based on two
exponentially-weighted moving averages the fleet feeds after every
``step()`` dispatch: the error rate (1.0 per raised step, 0.0 per clean
one) and the step latency.  Crossing the dead threshold — or a run of
consecutive errors, which catches a hard crash faster than any decaying
average can — OPENS the circuit breaker: the replica receives no
traffic and is not stepped for ``cooldown_steps`` fleet steps, then
moves to HALF-OPEN, where the fleet routes it exactly one probe
request.  A clean probe closes the circuit (EWMAs reset — the replica
earned a fresh record); a failed probe reopens it with the cooldown
multiplied by ``cooldown_backoff`` (capped), the standard
exponential-backoff breaker.

Cooldowns count FLEET STEPS, not wall seconds: the fleet is a
cooperative step loop, and step-counted state machines are exactly
reproducible under the fault harness (``faults.py``), which is how the
tests pin every transition.

Draining is orthogonal to the breaker: ``start_drain()`` stops
admission while the replica keeps stepping its in-flight requests;
when the fleet sees none left it calls ``finish_drain()`` (state
``drained``, not stepped).  ``reset()`` re-enlists a drained replica —
the rolling-restart handshake.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["HEALTHY", "DEGRADED", "DEAD", "DRAINING", "DRAINED",
           "STATE_CODES", "Ewma", "HealthConfig", "ReplicaHealth"]

HEALTHY = "healthy"
DEGRADED = "degraded"
DEAD = "dead"
DRAINING = "draining"
DRAINED = "drained"

# stable numeric encoding for the per-replica state gauge (a Prometheus
# gauge can't carry a string)
STATE_CODES = {HEALTHY: 0, DEGRADED: 1, DEAD: 2, DRAINING: 3,
               DRAINED: 4}


class Ewma:
    """Exponentially-weighted moving average: ``alpha`` is the weight
    of the newest sample (higher = faster to react, quicker to
    forgive)."""

    def __init__(self, alpha: float, value: float = 0.0):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.value = float(value)

    def update(self, x: float) -> float:
        self.value = self.alpha * float(x) + (1 - self.alpha) * self.value
        return self.value

    def reset(self, value: float = 0.0):
        self.value = float(value)


class HealthConfig:
    """Thresholds and breaker timings (all step-counted).

    - ``degraded_error_rate`` / ``dead_error_rate``: error-EWMA levels
      at which a replica is deprioritized / circuit-broken;
    - ``dead_consecutive``: hard-crash fast path — this many raises in
      a row opens the circuit regardless of the EWMA;
    - ``degraded_latency_s``: step-latency EWMA above this marks the
      replica degraded (None = latency never degrades — the right
      default when replica step times legitimately vary, e.g. mixed
      window sizes);
    - ``cooldown_steps`` → half-open after that many fleet steps;
      each failed probe multiplies the next cooldown by
      ``cooldown_backoff`` up to ``max_cooldown_steps``;
    - ``stall_steps``: the fleet's no-progress watchdog — a replica
      with live work that emits nothing for this many consecutive
      steps counts as erroring (catches stalls and result-droppers
      that never raise).
    """

    def __init__(self, error_alpha: float = 0.3,
                 latency_alpha: float = 0.3,
                 degraded_error_rate: float = 0.2,
                 dead_error_rate: float = 0.6,
                 dead_consecutive: int = 3,
                 degraded_latency_s: Optional[float] = None,
                 cooldown_steps: int = 8,
                 cooldown_backoff: float = 2.0,
                 max_cooldown_steps: int = 64,
                 stall_steps: int = 6):
        if not (0.0 < degraded_error_rate <= dead_error_rate <= 1.0):
            raise ValueError(
                f"need 0 < degraded_error_rate <= dead_error_rate <= 1,"
                f" got {degraded_error_rate}, {dead_error_rate}")
        if dead_consecutive < 1 or cooldown_steps < 1 or stall_steps < 1:
            raise ValueError("dead_consecutive, cooldown_steps and "
                             "stall_steps must be >= 1")
        self.error_alpha = error_alpha
        self.latency_alpha = latency_alpha
        self.degraded_error_rate = degraded_error_rate
        self.dead_error_rate = dead_error_rate
        self.dead_consecutive = dead_consecutive
        self.degraded_latency_s = degraded_latency_s
        self.cooldown_steps = cooldown_steps
        self.cooldown_backoff = cooldown_backoff
        self.max_cooldown_steps = max_cooldown_steps
        self.stall_steps = stall_steps


class ReplicaHealth:
    """Per-replica health record the fleet owns and feeds.

    ``ring`` (an :class:`~apex_tpu_torch.observability.EventRing`; ``None``
    resolves the CURRENT process ring per note, the same default as
    every other flight-recorder producer) receives
    one flight-recorder event per state-machine TRANSITION —
    ``breaker_open`` / ``breaker_half_open`` / ``breaker_close`` /
    ``breaker_reopen``, ``drain_start`` / ``drain_finish``,
    ``health_reset`` — tagged ``replica=name`` (the fleet passes the
    int replica INDEX, so breaker events join the fleet's own ring
    events on the same ``ev["replica"]`` key).  Transitions are rare
    by construction, so the ring holds the breaker's whole recent
    history at post-mortem time."""

    def __init__(self, config: Optional[HealthConfig] = None,
                 ring=None, name=None):
        self.config = config or HealthConfig()
        self.ring = ring
        self.name = name
        self.error_rate = Ewma(self.config.error_alpha)
        self.latency = Ewma(self.config.latency_alpha)
        self.consecutive_errors = 0
        self.circuit = "closed"              # closed | open | half_open
        self._cooldown = self.config.cooldown_steps
        self._cooldown_left = 0
        self.draining = False
        self.drained = False
        self.errors_total = 0

    def _note(self, kind: str, **attrs):
        from ..observability import flightrec
        flightrec.resolve(self.ring).append(kind, replica=self.name,
                                            **attrs)

    # -- fleet feed --------------------------------------------------------
    def record_success(self, latency_s: float):
        """A step dispatch with fleet-assigned work came back clean."""
        self.consecutive_errors = 0
        self.error_rate.update(0.0)
        self.latency.update(latency_s)
        if self.circuit == "half_open":
            # the probe survived: close, and the replica earns a fresh
            # record (a decaying 0.9 error EWMA would re-kill it on the
            # next single hiccup)
            self.circuit = "closed"
            self._cooldown = self.config.cooldown_steps
            self.error_rate.reset()
            self.latency.reset(latency_s)
            self._note("breaker_close")

    def record_error(self):
        """A step/prefill raised (or the stall watchdog fired)."""
        self.errors_total += 1
        self.consecutive_errors += 1
        self.error_rate.update(1.0)
        if self.circuit == "half_open":
            # failed probe: reopen with exponential backoff
            self._cooldown = min(
                int(self._cooldown * self.config.cooldown_backoff),
                self.config.max_cooldown_steps)
            self._open("breaker_reopen")
        elif self.circuit == "closed" and (
                self.consecutive_errors >= self.config.dead_consecutive
                or self.error_rate.value >= self.config.dead_error_rate):
            self._open("breaker_open")

    def _open(self, kind: str = "breaker_open"):
        self.circuit = "open"
        self._cooldown_left = self._cooldown
        self._note(kind, cooldown_steps=self._cooldown,
                   consecutive_errors=self.consecutive_errors,
                   error_rate=round(self.error_rate.value, 4))

    def set_cooldown(self, steps: int,
                     remaining: Optional[int] = None):
        """Actuator surface (``fleet.autoscale``): retune the
        breaker's step-counted cooldowns.  ``steps`` seeds the NEXT
        cooldown (capped at ``max_cooldown_steps``); ``remaining``,
        when the circuit is currently open, rewrites the steps left
        before the half-open probe — shortening it re-probes a broken
        replica sooner when the fleet is starved for capacity,
        lengthening it stops wasting probes on a replica that keeps
        failing them."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        self._cooldown = min(int(steps),
                             self.config.max_cooldown_steps)
        if remaining is not None and self.circuit == "open":
            self._cooldown_left = max(1, int(remaining))
        self._note("cooldown_set", cooldown_steps=self._cooldown,
                   remaining=(self._cooldown_left
                              if self.circuit == "open" else None))

    def tick(self):
        """Advance one fleet step of breaker time."""
        if self.circuit == "open":
            self._cooldown_left -= 1
            if self._cooldown_left <= 0:
                self.circuit = "half_open"
                self._note("breaker_half_open")

    # -- drain lifecycle ---------------------------------------------------
    def start_drain(self):
        self.draining = True
        self.drained = False
        self._note("drain_start")

    def finish_drain(self):
        self.draining = False
        self.drained = True
        self._note("drain_finish")

    def reset(self):
        """Re-enlist (post rolling-restart): fresh record, closed
        circuit, admission back on."""
        self.__init__(self.config, ring=self.ring, name=self.name)
        self._note("health_reset")

    # -- queries -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-python view of the whole health record — what
        ``Fleet.stats()`` lists per replica and the introspection
        server's ``/statusz`` serves: the derived state plus the
        breaker internals a 3am triage actually wants (how many
        consecutive errors, how much cooldown is left, what the EWMAs
        say)."""
        return {"replica": self.name,
                "state": self.state,
                "circuit": self.circuit,
                "error_rate": round(self.error_rate.value, 6),
                "latency_ewma_s": round(self.latency.value, 6),
                "consecutive_errors": self.consecutive_errors,
                "errors_total": self.errors_total,
                "cooldown_steps_left": (self._cooldown_left
                                        if self.circuit == "open"
                                        else 0),
                "next_cooldown_steps": self._cooldown,
                "draining": self.draining,
                "drained": self.drained}

    @property
    def cooldown_left(self) -> int:
        """Steps left before the half-open probe (0 unless open) —
        the public face of the breaker's clock for the autoscale
        controller and ``snapshot()``."""
        return self._cooldown_left if self.circuit == "open" else 0

    @property
    def state(self) -> str:
        if self.drained:
            return DRAINED
        if self.draining:
            return DRAINING
        if self.circuit == "open":
            return DEAD
        if self.circuit == "half_open":
            return DEGRADED
        c = self.config
        if self.error_rate.value >= c.degraded_error_rate or (
                c.degraded_latency_s is not None
                and self.latency.value >= c.degraded_latency_s):
            return DEGRADED
        return HEALTHY

    def admissible(self) -> bool:
        """May this replica receive NEW requests?  Half-open passes —
        the fleet itself enforces the one-probe budget (it knows the
        in-flight count; this record does not)."""
        return (not self.draining and not self.drained
                and self.circuit != "open")

    def steppable(self) -> bool:
        """Should the fleet call step() on this replica at all?"""
        return not self.drained and self.circuit != "open"
