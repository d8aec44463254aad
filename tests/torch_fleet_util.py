"""Shared pieces of the fleet parity tests (tests/test_torch_fleet.py,
test_torch_qos.py, test_torch_autoscale.py, test_torch_exporters.py).

- :class:`StubReplica`: one deterministic, stdlib-only copy of the JAX
  fleet tests' scheduler-surface stub (``_StubReplica`` of
  tests/test_fleet.py and tests/test_qos.py, ``_Stub`` of
  tests/test_autoscale.py).  Request k's token j is ``100 * len(prompt)
  + j``, so restart exactness holds by construction and a twin pins the
  orchestration.  :class:`WindowStub` adds the duck-typed ``set_window``
  knob the autoscale controller actuates (no engine of either package
  has it).
- :class:`TickClock`: the injected clock; a twin advances it by whole
  ticks, so latencies, goodput windows and ring timestamps are exact.
- :func:`package`: the fleet and observability modules of either
  package under one namespace, so one scenario function drives both.
- :func:`observe` / :func:`twin`: what a twin compares — every
  request's outcome, ``stats()`` less ``replica_stats``, ``record()``,
  the ring's events in order, and the metrics by name and value, as JSON
  with the fleets' trace ids normalized.
"""

import json
import re
import types


class StubReplica:
    """The JAX fleet tests' stub replica (the scheduler surface)."""

    def __init__(self, slots=2):
        self.slots = slots
        self._free = list(range(slots))
        self._live = {}                  # rid -> [prompt, max_new, got]
        self._waiting = []
        self._finished = {}
        self._next_rid = 0

    @staticmethod
    def expected(prompt, max_new):
        return [100 * len(prompt) + j for j in range(max_new)]

    def _admit(self, rid, prompt, max_new):
        self._free.pop()
        self._live[rid] = [list(prompt), max_new, []]

    def add_request(self, prompt, max_new_tokens, eos_token_id=None,
                    seed=None, temperature=None):
        if not self._free:
            raise RuntimeError("no free slot")
        rid = self._next_rid
        self._next_rid += 1
        self._admit(rid, prompt, max_new_tokens)
        return rid

    def submit(self, prompt, max_new_tokens, eos_token_id=None,
               seed=None, temperature=None):
        if self._free and not self._waiting:
            return self.add_request(prompt, max_new_tokens)
        rid = self._next_rid
        self._next_rid += 1
        self._waiting.append((rid, list(prompt), max_new_tokens,
                              eos_token_id, seed, temperature))
        return rid

    def step(self):
        out = {}
        for rid, rec in list(self._live.items()):
            prompt, max_new, got = rec
            tok = 100 * len(prompt) + len(got)
            got.append(tok)
            out[rid] = [tok]
            if len(got) >= max_new:
                del self._live[rid]
                self._free.append(0)
                self._finished[rid] = got
        while self._free and self._waiting:
            rid, prompt, max_new, *_ = self._waiting.pop(0)
            self._admit(rid, prompt, max_new)
        return out

    def live(self):
        return len(self._live)

    def free_slots(self):
        return len(self._free)

    def queue_depth(self):
        return len(self._waiting)

    def is_finished(self, rid):
        return rid in self._finished

    def result(self, rid):
        return list(self._finished[rid])

    def cancel(self, rid):
        for i, item in enumerate(self._waiting):
            if item[0] == rid:
                del self._waiting[i]
                return True
        if rid in self._live:
            del self._live[rid]
            self._free.append(0)
            return True
        return False

    def take_waiting(self):
        taken, self._waiting = self._waiting, []
        return taken

    def register_prefix(self, tokens):
        return 0

    def stats(self):
        return {"live": len(self._live), "slots": self.slots,
                "occupancy": len(self._live) / self.slots,
                "queue_depth": len(self._waiting),
                "free": len(self._free)}


class WindowStub(StubReplica):
    """A stub with the decode-window knob the controller actuates."""

    def __init__(self, slots=2, window=8):
        super().__init__(slots)
        self.window = window
        self.base_window = window

    def set_window(self, k):
        self.window = int(k)


class TickClock:
    """The injected clock: ``t`` advances only when a test says so."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def package(name):
    """The fleet and observability modules of the JAX package
    (``"jax"``) or the port (``"port"``) under one namespace."""
    if name == "jax":
        from apex_tpu import fleet, observability as obs
        from apex_tpu.fleet import qos, recovery, slo
        from apex_tpu.observability import exporters, flightrec
    else:
        from apex_tpu_torch import fleet, observability as obs
        from apex_tpu_torch.fleet import qos, recovery, slo
        from apex_tpu_torch.observability import exporters, flightrec
    return types.SimpleNamespace(name=name, fleet=fleet, obs=obs, qos=qos,
                                 recovery=recovery, slo=slo,
                                 exporters=exporters, flightrec=flightrec)


def drive(fl, limit=300, clock=None):
    """Step until nothing is owed; ``clock`` advances one tick a step."""
    n = 0
    while fl.live():
        fl.step()
        if clock is not None:
            clock.t += 1.0
        n += 1
        assert n < limit, "fleet failed to converge"
    return n


def metric_value(m):
    return m.summary() if hasattr(m, "summary") else m.value


def metric_dump(registry):
    """name -> (kind, value or histogram summary, labelled children)."""
    return {m.name: (type(m).__name__, metric_value(m),
                     {str(k): metric_value(c)
                      for k, c in m.children().items()},
                     m.labels_dropped)
            for m in registry.collect()}


def outcome(fl, rid):
    st = fl.status(rid)
    if st == "finished":
        return st, [int(t) for t in fl.result(rid)]
    if st == "failed":
        return st, fl._results[rid].error
    return st, None


def observe(fl, rids=(), ring=None):
    """The observables of a fleet run that a twin holds equal."""
    stats = fl.stats()
    stats.pop("replica_stats")
    return {"results": [outcome(fl, r) for r in rids], "stats": stats,
            "record": fl.record(),
            "ring": (ring if ring is not None else fl.ring).snapshot(),
            "metrics": metric_dump(fl.metrics)}


# a fleet's trace id counts the ids its package minted before it
_TRACE_ID = re.compile(r"fleet-[0-9a-f]+-[0-9a-f]+")


def canon(obj):
    """``obj`` as sorted JSON, fleet trace ids normalized: equal strings
    are equal observables (floats to the last bit, NaN included)."""
    return _TRACE_ID.sub("fleet-*", json.dumps(obj, sort_keys=True,
                                                default=repr))


def twin(scenario, *args, **kwargs):
    """``scenario(pk, ...)`` on the JAX package and on the port; every
    observable it returns must be equal.  Returns the port's."""
    got = {name: scenario(package(name), *args, **kwargs)
           for name in ("jax", "port")}
    want, have = got["jax"], got["port"]
    if isinstance(want, dict) and isinstance(have, dict):
        assert sorted(have) == sorted(want)
        for key in want:
            assert canon(have[key]) == canon(want[key]), key
    else:
        assert canon(have) == canon(want)
    return have
