"""Multi-tenant QoS: priority classes and weighted-fair admission.

The fleet used to treat every request identically — one bounded FIFO
queue, one SLO.  This module is the scheduling plane that replaces the
FIFO: a :class:`QosPolicy` names the priority classes (weight, default
deadline, queue share, preemptibility) and maps tenants onto them, and
a :class:`WfqQueue` orders the pending queue by deterministic stride
scheduling (virtual-time weighted-fair queuing) so a low-priority
flood cannot starve a high-priority trickle.

Design constraints, in order:

1. **Drop-in for the FIFO.**  ``Fleet._pending`` used to be a plain
   list and half the fleet (and its tests) touch it directly:
   ``len()``, iteration, ``remove(req)``, ``append(req)``, ``[0]``
   indexing, and the failover/drain front-requeue idiom
   ``self._pending[:0] = moved``.  ``WfqQueue`` supports every one of
   those, and under the default single-class policy its iteration
   order IS submission order — byte-for-byte FIFO, so a fleet built
   without a policy behaves exactly as before.
2. **Deterministic.**  Stride scheduling over integer virtual time:
   each class holds a persistent ``pass`` value advanced by
   ``STRIDE_SCALE // weight`` per dequeue; the merged order always
   picks the minimum pass (priority order breaks ties).  No clocks,
   no randomness — the same submissions in the same order always
   dispatch in the same order, which is what lets preemption-exactness
   tests pin tokens.
3. **No starvation either way.**  Weighted-fair means the batch class
   still drains under an interactive trickle (its pass catches up),
   and a class waking from empty inherits the minimum live pass so it
   cannot monopolize the queue with a stale low pass.

Per-class admission: ``queue_share`` bounds how much of the fleet's
``max_queue`` one class may occupy, so a flood sheds against its own
quota (per-class ``FleetOverloaded``) long before it squeezes the
interactive class out of the queue.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence

__all__ = ["QosClass", "QosPolicy", "WfqQueue", "DEFAULT_CLASS",
           "STRIDE_SCALE"]

# Integer stride numerator.  Large enough that weight ratios up to
# ~1e5 stay exact in integer division; virtual time is unbounded
# Python int so overflow is not a concern.
STRIDE_SCALE = 1 << 20

# Name of the implicit class a policy-less fleet runs under.
DEFAULT_CLASS = "default"


class QosClass:
    """One priority class: scheduling weight plus per-class knobs.

    ``weight``       relative share of dispatch bandwidth (stride
                     scheduling: a weight-8 class dequeues 8x as often
                     as a weight-1 class under contention).
    ``deadline_s``   default request deadline applied at submit when
                     the caller did not pass one (None = no default).
    ``queue_share``  fraction of ``Fleet.max_queue`` this class may
                     occupy (None = the whole queue).  The effective
                     cap is ``max(1, int(share * max_queue))`` so a
                     tiny share never rounds to an un-admittable 0.
    ``preemptible``  whether in-flight requests of this class may be
                     evicted mid-decode to admit a higher class.
    """

    __slots__ = ("name", "weight", "deadline_s", "queue_share",
                 "preemptible")

    def __init__(self, name: str, weight: int = 1,
                 deadline_s: Optional[float] = None,
                 queue_share: Optional[float] = None,
                 preemptible: bool = True):
        if not isinstance(name, str) or not name:
            raise ValueError(f"class name must be a non-empty string, "
                             f"got {name!r}")
        if not isinstance(weight, int) or isinstance(weight, bool) \
                or weight < 1:
            raise ValueError(f"weight must be an int >= 1, got "
                             f"{weight!r}")
        if deadline_s is not None and not deadline_s > 0:
            raise ValueError(f"deadline_s must be > 0 or None, got "
                             f"{deadline_s!r}")
        if queue_share is not None and not (0.0 < queue_share <= 1.0):
            raise ValueError(f"queue_share must be in (0, 1] or None, "
                             f"got {queue_share!r}")
        self.name = name
        self.weight = weight
        self.deadline_s = deadline_s
        self.queue_share = queue_share
        self.preemptible = bool(preemptible)

    @property
    def stride(self) -> int:
        return STRIDE_SCALE // self.weight

    def spec(self) -> Dict[str, object]:
        """JSON-ready view (for /tenantz class blocks and records)."""
        return {"weight": self.weight, "deadline_s": self.deadline_s,
                "queue_share": self.queue_share,
                "preemptible": self.preemptible}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"QosClass({self.name!r}, weight={self.weight}, "
                f"deadline_s={self.deadline_s}, "
                f"queue_share={self.queue_share}, "
                f"preemptible={self.preemptible})")


class QosPolicy:
    """Priority classes in rank order plus the tenant -> class map.

    ``classes`` is a sequence of :class:`QosClass` in PRIORITY order:
    the first class outranks every later one (rank 0 is highest).
    Rank decides preemption direction (only a strictly higher-ranked
    request may evict a lower-ranked one) and breaks virtual-time
    ties, so equal-pass contention resolves toward the interactive
    class deterministically.

    Untagged traffic lands in ``default_class`` — by default the LAST
    (lowest-priority) class, because anonymous traffic should never
    outrank explicitly tagged interactive requests.

    Class resolution at submit (:meth:`resolve`) is total, never
    raising: an explicit ``priority=`` naming a known class wins, then
    the tenant mapping, then the default class.  Unknown priorities
    fold to the default rather than erroring so pre-QoS callers that
    stamped free-form priority tags keep working.
    """

    def __init__(self, classes: Sequence[QosClass],
                 tenant_class: Optional[Mapping[str, str]] = None,
                 default_class: Optional[str] = None):
        if not classes:
            raise ValueError("QosPolicy needs at least one class")
        self.classes: Dict[str, QosClass] = {}
        for c in classes:
            if not isinstance(c, QosClass):
                raise TypeError(f"classes must be QosClass instances, "
                                f"got {type(c).__name__}")
            if c.name in self.classes:
                raise ValueError(f"duplicate class {c.name!r}")
            self.classes[c.name] = c
        self._rank = {name: i for i, name in enumerate(self.classes)}
        self.tenant_class: Dict[str, str] = dict(tenant_class or {})
        for t, c in self.tenant_class.items():
            if c not in self.classes:
                raise ValueError(f"tenant {t!r} maps to unknown class "
                                 f"{c!r}")
        if default_class is None:
            default_class = next(reversed(self.classes))
        if default_class not in self.classes:
            raise ValueError(f"default_class {default_class!r} is not "
                             f"a declared class")
        self.default_class = default_class

    @classmethod
    def single(cls) -> "QosPolicy":
        """The implicit policy of a QoS-less fleet: one class holding
        the whole queue — WFQ over it degenerates to exact FIFO."""
        return cls([QosClass(DEFAULT_CLASS, weight=1)])

    def resolve(self, tenant: Optional[str] = None,
                priority: Optional[str] = None) -> str:
        if priority is not None and priority in self.classes:
            return priority
        if tenant is not None:
            mapped = self.tenant_class.get(tenant)
            if mapped is not None:
                return mapped
        return self.default_class

    def rank(self, name: str) -> int:
        """0 = highest priority; unknown classes rank below all."""
        return self._rank.get(name, len(self._rank))

    def deadline_for(self, name: str) -> Optional[float]:
        c = self.classes.get(name)
        return c.deadline_s if c is not None else None

    def preemptible(self, name: str) -> bool:
        c = self.classes.get(name)
        return c.preemptible if c is not None else True

    def cap(self, name: str, max_queue: int) -> int:
        """Effective per-class queue cap under a fleet ``max_queue``."""
        c = self.classes.get(name)
        share = c.queue_share if c is not None else None
        if share is None:
            return max_queue
        return max(1, int(share * max_queue))

    def spec(self) -> Dict[str, Dict[str, object]]:
        return {name: c.spec() for name, c in self.classes.items()}


class WfqQueue:
    """List-compatible pending queue ordered by stride scheduling.

    Holds one FIFO per class plus a persistent integer ``pass`` value
    per class.  The merged iteration order simulates the scheduler:
    repeatedly take the non-empty class with the minimum pass (rank
    breaks ties), yield its head, and advance the simulated pass by
    the class stride.  The REAL pass advances in :meth:`remove` —
    i.e. when the fleet actually takes a request out (dispatch, shed
    sweep, deadline sweep) — which keeps the virtual clock in step
    with service actually consumed.

    Front-requeue (``q[:0] = moved``, the failover/drain idiom)
    reinserts each request at the head of its own class queue without
    touching virtual time, mirroring what the old list did: a
    reclaimed request goes back to the front of ITS line, not the
    front of everyone's.
    """

    def __init__(self, policy: Optional[QosPolicy] = None):
        self.policy = policy or QosPolicy.single()
        self._q: Dict[str, List[object]] = {
            name: [] for name in self.policy.classes}
        self._pass: Dict[str, int] = {
            name: 0 for name in self.policy.classes}

    # -- class helpers ----------------------------------------------

    def class_of(self, req: object) -> str:
        name = getattr(req, "qos_class", None)
        if name is None or name not in self._q:
            return self.policy.default_class
        return name

    def class_depths(self) -> Dict[str, int]:
        return {name: len(q) for name, q in self._q.items()}

    def depth(self, name: str) -> int:
        return len(self._q.get(name, ()))

    # -- the stride schedule ----------------------------------------

    def _order(self) -> List[object]:
        passes = dict(self._pass)
        idx = {name: 0 for name in self._q}
        out: List[object] = []
        names = list(self.policy.classes)  # rank order = tiebreak
        remaining = sum(len(q) for q in self._q.values())
        while remaining:
            best = None
            for name in names:
                if idx[name] >= len(self._q[name]):
                    continue
                if best is None or passes[name] < passes[best]:
                    best = name
            q = self._q[best]
            out.append(q[idx[best]])
            idx[best] += 1
            passes[best] += self.policy.classes[best].stride
            remaining -= 1
        return out

    def _catch_up(self, name: str) -> None:
        # A class waking from empty inherits the minimum live pass so
        # a long-idle class cannot replay its idle time as credit.
        live = [self._pass[n] for n, q in self._q.items()
                if q and n != name]
        if live:
            self._pass[name] = max(self._pass[name], min(live))

    # -- list protocol (the Fleet._pending contract) -----------------

    def append(self, req: object) -> None:
        name = self.class_of(req)
        if not self._q[name]:
            self._catch_up(name)
        self._q[name].append(req)

    def remove(self, req: object) -> None:
        name = self.class_of(req)
        try:
            self._q[name].remove(req)
        except ValueError:
            # class tag mutated after enqueue — fall back to a sweep
            for q in self._q.values():
                if req in q:
                    q.remove(req)
                    break
            else:
                raise
        self._pass[name] += self.policy.classes[name].stride \
            if name in self.policy.classes else STRIDE_SCALE

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def __iter__(self) -> Iterator[object]:
        return iter(self._order())

    def __getitem__(self, i):
        order = self._order()
        return order[i]

    def __setitem__(self, key, value) -> None:
        # Only the front-requeue idiom ``q[:0] = moved`` is supported;
        # anything else on a scheduled queue is a bug.
        if not (isinstance(key, slice) and key.start is None
                and key.stop == 0 and key.step is None):
            raise TypeError("WfqQueue only supports front-requeue "
                            "slice assignment q[:0] = [...]")
        for req in reversed(list(value)):
            name = self.class_of(req)
            if not self._q[name]:
                self._catch_up(name)
            self._q[name].insert(0, req)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"WfqQueue({self.class_depths()}, "
                f"passes={self._pass})")
