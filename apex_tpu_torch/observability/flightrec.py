"""Flight recorder: a bounded ring of operational events for
post-mortems.

Metrics tell you *how much*, spans tell you *how long*; the flight
ring tells you *what happened right before it broke*.  It records the
rare, state-changing transitions a 3am page needs — circuit-breaker
opens/closes, failovers, drains, stall-watchdog fires, amp-scaler
skips, injected faults — in a fixed-capacity deque, so a process that
runs for weeks holds exactly the last ``capacity`` transitions and
nothing more.  ``dump()`` writes the ring as JSONL the moment a fault
fires (``Fleet(flight_dump_path=...)`` wires that automatically).

Every event carries a monotonically-increasing ``seq`` (survives ring
wraparound — the gap between the first retained ``seq`` and 0 is the
drop count), the recorder-relative timestamp, the event ``kind``, and
arbitrary attrs.  Appends are lock-protected and cheap (one dict + one
deque append), safe from the fleet's worker threads.

Producers in-tree: ``fleet.Fleet`` (failover / shed / retry / deadline
/ stall-watchdog / drain), ``fleet.health.ReplicaHealth`` (breaker
transitions), ``fleet.faults.FaultyReplica`` (injected faults),
``amp.record_scaler`` (scaler skips).  Fleet events for tagged
requests carry the request's ``tenant`` (shed and deadline events say
WHOSE request suffered); aggregate transitions touching several
requests (failover reclaim, deadline sweep) carry the affected
``tenants`` list — ``snapshot(tenant=...)`` / ``/flightz?tenant=``
filter on both.  All default to the process ring
(:func:`get_ring`) so one dump shows the interleaved story; pass an
explicit ring to isolate a fleet (tests do).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["EventRing", "event_matches_tenant", "get_ring",
           "set_ring", "resolve", "record"]


def event_matches_tenant(event: Dict[str, Any], tenant: str) -> bool:
    """THE membership rule for "is this event part of ``tenant``'s
    story": a per-request event stamped ``tenant: <name>`` matches,
    and so does an aggregate transition (failover reclaim, deadline
    sweep, preemption) listing the name in its ``tenants`` list.
    Both :meth:`EventRing.snapshot` and ``/flightz?tenant=`` call
    this one function, so a post-mortem dump filter and a live scrape
    can never drift apart."""
    return (event.get("tenant") == tenant
            or tenant in (event.get("tenants") or ()))


class EventRing:
    """Bounded, thread-safe operational-event ring."""

    def __init__(self, capacity: int = 1024, clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0

    def append(self, kind: str, **attrs) -> Dict[str, Any]:
        """Record one transition; returns the stored event."""
        ev = {"kind": kind}
        if attrs:
            ev.update(attrs)
        with self._lock:
            # clock read under the lock WITH the seq assignment, so
            # timestamp order and seq order can never disagree in a
            # dump (time running backwards across adjacent seqs would
            # reorder causally-ordered transitions for a reader
            # sorting by t)
            ev["t"] = self._clock() - self._t0
            ev["seq"] = self._seq
            self._seq += 1
            self._events.append(ev)
        return ev

    def snapshot(self, kind: Optional[str] = None,
                 tenant: Optional[str] = None) -> List[Dict[str, Any]]:
        """Retained events oldest-first (optionally one kind and/or
        one tenant's story).  The tenant filter matches both the
        per-request events stamped ``tenant: <name>`` and the
        aggregate transitions (failover reclaim, deadline sweep) that
        list every affected tenant in ``tenants`` — the same rule
        ``/flightz?tenant=`` serves, so a post-mortem and a live
        scrape answer "whose request suffered" identically."""
        with self._lock:
            evs = [dict(e) for e in self._events]
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if tenant is not None:
            evs = [e for e in evs if event_matches_tenant(e, tenant)]
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def total(self) -> int:
        """Events ever appended (>= len: the ring drops oldest)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._seq - len(self._events)

    def stats(self) -> Dict[str, int]:
        """One consistent accounting snapshot (capacity / total ever
        appended / retained / dropped) — the ``/flightz`` header; taken
        under one lock acquisition so ``total == retained + dropped``
        holds even mid-append."""
        with self._lock:
            n = len(self._events)
            return {"capacity": self.capacity, "total": self._seq,
                    "retained": n, "dropped": self._seq - n}

    def clear(self):
        with self._lock:
            self._events.clear()

    def dump(self, path: str) -> str:
        """Write the ring as JSONL (atomic replace): one header line
        with the drop accounting, then every retained event oldest
        first — the post-mortem artifact."""
        with self._lock:
            evs = [dict(e) for e in self._events]
            header = {"kind": "flight_ring", "capacity": self.capacity,
                      "total": self._seq,
                      "dropped": self._seq - len(evs)}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            # default=repr: a producer may have appended a non-JSON
            # attr (np scalar, exception object); the post-mortem dump
            # must stringify it, never raise mid-failover
            f.write(json.dumps(header) + "\n")
            for ev in evs:
                f.write(json.dumps(ev, default=repr) + "\n")
        os.replace(tmp, path)
        return path


_global_ring = EventRing()


def get_ring() -> EventRing:
    """The process-wide default ring (fleet health, fault harness, and
    amp scaler skips land here unless handed an explicit ring)."""
    return _global_ring


def set_ring(ring: EventRing) -> EventRing:
    global _global_ring
    prev, _global_ring = _global_ring, ring
    return prev


def resolve(ring: Optional[EventRing]) -> EventRing:
    """An explicit ring, else the CURRENT process ring.  Producers
    holding an optional ring call this per append (not once at
    construction) so a :func:`set_ring` swap moves every producer's
    story to the new ring together."""
    return ring if ring is not None else _global_ring


def record(kind: str, **attrs) -> Dict[str, Any]:
    """Append to the process-wide default ring."""
    return _global_ring.append(kind, **attrs)
