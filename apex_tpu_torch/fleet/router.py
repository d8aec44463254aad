"""Routing policies, retry/backoff, and fleet-level backpressure.

A policy answers one question per dispatch: *which admissible replica
takes this request?*  The fleet pre-filters the candidate list (healthy
before degraded, free slot required, breaker/drain respected), so
policies stay pure ranking functions over live scheduler stats and are
trivially testable.

Every ``select`` also leaves ``last_decision`` — a small
JSON-serializable dict saying *why* that replica won (per-candidate
loads, the matched prefix owner, the rotation cursor).  The fleet
copies it onto the request's ``fleet_route`` trace event, so a flight
record answers "why replica 2?" without re-deriving the ranking.

- :class:`RoundRobin` — cycle through candidates; the baseline.
- :class:`LeastLoaded` — rank by each replica's ``stats()`` occupancy
  plus its queue depth (normalized by slot count), ties to the lowest
  index.  The default.
- :class:`PrefixAffinity` — prompts sharing a prefix registered through
  ``Fleet.register_prefix`` route to the replica holding that prefix's
  pool row (its KV splice makes admission cheap THERE and nowhere
  else); everything else falls through to an inner policy.

:class:`RetryPolicy` is the dispatch-failure schedule: exponential
backoff with seeded jitter, measured in FLEET STEPS so the whole retry
timeline is deterministic under the fault harness.  ``max_attempts``
exhausted fails the request (``Fleet.result`` raises with the last
error).  :class:`FleetOverloaded` is the explicit shed signal raised by
``Fleet.submit`` when the bounded fleet queue is full — retriable by
construction: the queue drains as replicas finish work.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["FleetOverloaded", "RetryPolicy", "RoundRobin",
           "LeastLoaded", "PrefixAffinity", "make_policy"]


class FleetOverloaded(RuntimeError):
    """The bounded fleet queue is full: the request was SHED, not
    queued.  Retriable — resubmit after backoff; ``queue_depth`` and
    ``max_queue`` say how far over capacity the caller found us.
    Under a multi-class :class:`~apex_tpu_torch.fleet.qos.QosPolicy`,
    ``qos_class`` names the priority class whose quota (or the global
    queue) rejected the submit — a batch client seeing its own class
    here knows backing off harder won't help the interactive tier,
    it IS the relief."""

    def __init__(self, queue_depth: int, max_queue: int,
                 qos_class=None):
        cls = f" [class {qos_class}]" if qos_class is not None else ""
        super().__init__(
            f"fleet queue full ({queue_depth}/{max_queue}){cls}; "
            f"request shed — retry after backoff")
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        self.qos_class = qos_class


class RetryPolicy:
    """Exponential backoff with full seeded jitter, in fleet steps.

    Attempt k (0-based) that fails waits
    ``min(base_delay_steps * backoff**k, max_delay_steps)`` steps,
    scaled by ``uniform(1 - jitter, 1 + jitter)`` from a seeded RNG —
    deterministic per policy instance, which is what lets the tests
    pin exact retry timelines."""

    def __init__(self, max_attempts: int = 4,
                 base_delay_steps: int = 1,
                 max_delay_steps: int = 16,
                 backoff: float = 2.0,
                 jitter: float = 0.5,
                 seed: int = 0):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{max_attempts}")
        if not (0.0 <= jitter < 1.0):
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.max_attempts = max_attempts
        self.base_delay_steps = base_delay_steps
        self.max_delay_steps = max_delay_steps
        self.backoff = backoff
        self.jitter = jitter
        self._rng = np.random.RandomState(seed)

    def delay_steps(self, attempt: int) -> int:
        """Steps to wait after failed attempt number ``attempt``
        (0-based)."""
        d = min(self.base_delay_steps * self.backoff ** attempt,
                float(self.max_delay_steps))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.uniform() - 1.0)
        return max(1, int(round(d)))


# -- policies --------------------------------------------------------------

def _req_tags(req) -> dict:
    """Tenant/priority tags of a request, for ``last_decision``: the
    routing record of a tagged request says WHOSE request was ranked
    (the fleet copies the decision onto the ``fleet_route`` trace
    event; the QoS plane consumes the priority BEFORE
    routing — the WfqQueue decides who meets the router first, the
    policy only decides where — and the fleet stamps the resolved
    ``qos_class`` on the trace event itself).  Untagged requests keep
    the pre-tenant decision shape."""
    tags = {}
    tenant = getattr(req, "tenant", None)
    if tenant is not None:
        tags["tenant"] = tenant
    priority = getattr(req, "priority", None)
    if priority is not None:
        tags["priority"] = priority
    return tags


def _load(replica) -> float:
    """Occupancy + queued work, both normalized per slot — one scalar
    'how busy' from the scheduler's cheap accessors (``stats()`` is
    too heavy for a per-dispatch read)."""
    slots = max(replica.slots, 1)
    return replica.live() / slots + replica.queue_depth() / slots


class RoundRobin:
    """Cycle through the candidate list."""
    name = "round_robin"

    def __init__(self):
        self._next = 0
        self.last_decision = None

    def select(self, fleet, candidates: Sequence[int], req) -> int:
        # candidates are sorted replica indices; take the first one at
        # or after the cursor so removal of a replica (drain/death)
        # cannot wedge the rotation
        cursor = self._next
        pick = next((i for i in candidates if i >= cursor),
                    candidates[0])
        self._next = pick + 1
        self.last_decision = {"cursor": cursor, "wrapped":
                              pick < cursor, **_req_tags(req)}
        return pick


class LeastLoaded:
    """Lowest occupancy+queue replica wins; ties to the lowest
    index."""
    name = "least_loaded"

    def __init__(self):
        self.last_decision = None

    def select(self, fleet, candidates: Sequence[int], req) -> int:
        loads = {i: _load(fleet.replicas[i]) for i in candidates}
        pick = min(candidates, key=lambda i: (loads[i], i))
        # JSON object keys are strings; stringify (and round for
        # display only — selection uses full precision) so the
        # decision survives the trace record round-trip unchanged
        self.last_decision = {"load": {str(i): round(loads[i], 4)
                                       for i in candidates},
                              **_req_tags(req)}
        return pick


class PrefixAffinity:
    """Route prompts to the replica holding their registered prefix.

    ``Fleet.register_prefix`` prefills the prefix into ONE replica's
    pool and records the owner; a prompt starting with a registered
    prefix prefers that owner (longest match wins) whenever it is an
    admissible candidate — landing the request on the replica where
    admission is a KV splice instead of a full prefill.  Everything
    else (no match, owner dead/draining/full) falls through to
    ``fallback``."""
    name = "prefix_affinity"

    def __init__(self, fallback=None):
        self.fallback = fallback or LeastLoaded()
        self.last_decision = None

    def select(self, fleet, candidates: Sequence[int], req) -> int:
        owner = fleet.prefix_owner(req.prompt)
        if owner is not None and owner in candidates:
            self.last_decision = {"prefix_owner": owner,
                                  **_req_tags(req)}
            return owner
        pick = self.fallback.select(fleet, candidates, req)
        self.last_decision = {
            # owner set but inadmissible (dead/draining/full) is the
            # interesting trace distinction vs no registered match
            "prefix_owner": owner, "fallback":
            getattr(self.fallback, "name",
                    type(self.fallback).__name__),
            **(getattr(self.fallback, "last_decision", None) or {})}
        return pick


_POLICIES = {"round_robin": RoundRobin, "least_loaded": LeastLoaded,
             "prefix_affinity": PrefixAffinity}


def make_policy(policy) -> object:
    """Resolve a policy name or pass an instance through."""
    if isinstance(policy, str):
        try:
            return _POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown routing policy {policy!r}; known: "
                f"{sorted(_POLICIES)}") from None
    if not hasattr(policy, "select"):
        raise TypeError(f"policy must be a name or expose "
                        f".select(fleet, candidates, req); got "
                        f"{type(policy).__name__}")
    return policy
