"""Compilation-plane ledger: every CUDA-graph capture and kernel build,
measured in-process.

Counterpart of ``apex_tpu/observability/compilation.py``.  The JAX
package records every jit TRACE of an instrumented entry; the port's
counterpart of a trace is **the first call of an instrumented entry at a
new abstract signature**:

- on the card that call is the capture of the entry's CUDA graph
  (``_graph.CapturedStep`` / ``_graph.CapturedFn``: call 1 is the eager
  warm-up, call 2 captures), recorded at the capture with the capture's
  wall time as the compile time;
- on the CPU, where nothing captures, it is the entry's first eager
  call, so the ledger counts the same on both devices;
- an eager function wrapped by :func:`instrumented_jit` records each
  signature the first time it sees it (jit's cache: a signature seen
  before is a cache hit and records nothing).

:class:`CompilationLedger` records each such trace (the entry label, the
abstract argument signature, the wall duration, the cache attribution,
a signature fingerprint) and classifies its CAUSE against the closure's
previous signature via the retrace differ (:func:`diff_signatures`),
which names *which argument* changed and how.  A captured step is
shape-static: ``CapturedStep`` refuses a batch of another shape, and
records the refused signature through the differ before it raises, so
the refusal's culprit reaches the ring as a JAX retrace's would.

The cache column: the JAX package attributes each compile to its
persistent compilation cache.  The port's counterpart is the kernel
build cache of ``ops._build``: each CUDA source is recorded once a
process under an ``nvcc:<name>`` entry, ``hit`` when its shared library
was already built, ``miss`` when ``nvcc`` ran, with the build's seconds
as its wall time.  A capture has no persistent cache: ``uncached``.

Causes (:data:`RETRACE_CAUSES`):

- ``new_entry`` — the entry's first trace ever (the expected warmup
  capture);
- ``shape`` / ``dtype`` / ``static_arg`` — a *signature-change*
  retrace: some argument's abstract signature differs from THIS
  closure's previous trace (the diff always runs against the same
  closure's own history); the differ names the culprit argument and its
  before/after signatures.  These are the storm class and the only
  causes that reach the flight ring (``xla_retrace`` events — the
  ``RunSupervisor``'s ``recompilation_storm`` detector feeds on them);
- ``new_closure`` — a *fresh* closure's first trace of an already-known
  entry, whatever its signature: the per-replica class (every ``Engine``
  instance captures its own graphs), which
  :meth:`~apex_tpu_torch.fleet.Fleet.warmup` exists to pay before
  traffic;
- ``repeat`` — the same closure recorded an identical signature again.

Metrics (process registry unless the ledger is given one), under the
JAX package's names so the exporters and dashboards read them unchanged:
``xla_traces_total{entry}``, ``xla_retraces_total{entry, cause}``,
``xla_compiles_total{entry, cache}`` (cache in hit/miss/uncached),
``xla_compile_seconds`` (wall duration of recording dispatches).

The zero-retrace contracts are delta checks over :meth:`total_traces`:
after warmup, N mixed decode windows or a fleet failover restarting
reclaimed requests on survivors add exactly 0 traces.

Import-light (stdlib at module scope; torch only inside
:func:`abstract_signature`'s leaf walk): the ``/compilez`` endpoint and
``tests/ci/server_smoke_torch.py`` consume snapshots without the rest of
the package.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["RETRACE_CAUSES", "SIGNATURE_CHANGE_CAUSES",
           "BENCH_COMPILE_FIELDS", "CompilationLedger",
           "abstract_signature", "diff_signatures", "format_signature",
           "signature_fingerprint", "instrumented_jit",
           "get_ledger", "set_ledger"]

# every cause a recorded trace can carry (see module docstring)
RETRACE_CAUSES = ("new_entry", "shape", "dtype", "static_arg",
                  "new_closure", "repeat")
# the storm class: a signature actually CHANGED between two traces of
# one entry — only these reach the flight ring / supervisor detector
SIGNATURE_CHANGE_CAUSES = ("shape", "dtype", "static_arg")

# the schema-v10 bench fields every fresh train/engine line carries —
# duplicated stdlib-side in exporters.COMPILE_FIELDS (pinned equal in
# tests: both modules stay importable without the rest of the package)
BENCH_COMPILE_FIELDS = ("cold_compile_ms", "compiles_total",
                        "steady_state_retraces")

# compile wall durations span sub-ms toy CPU traces to minutes-scale
# hardware compiles
_COMPILE_SECONDS_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                            1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
                            300.0)

_closure_ids = itertools.count()

# per-thread stack of in-flight instrumented dispatches: a recording
# call and the kernel builds it triggers attribute what they see to the
# top of the dispatching thread's stack
_inflight = threading.local()


def _stack() -> List["_Dispatch"]:
    st = getattr(_inflight, "stack", None)
    if st is None:
        st = _inflight.stack = []
    return st


def current_dispatch() -> Optional["_Dispatch"]:
    st = _stack()
    return st[-1] if st else None


class _Dispatch:
    """One in-flight call of an instrumented entry: collects the trace
    events recorded during it plus the kernel builds (hit or miss) that
    ran on this thread meanwhile."""

    __slots__ = ("ledger", "entry", "events", "cache_hits",
                 "cache_misses", "backend_compile_s")

    def __init__(self, ledger: "CompilationLedger", entry: str):
        self.ledger = ledger
        self.entry = entry
        self.events: List[Dict[str, Any]] = []
        self.cache_hits = 0
        self.cache_misses = 0
        self.backend_compile_s = 0.0

    @property
    def cache_label(self) -> str:
        # a partial hit (some nested executable missed) is a miss for
        # the dispatch: something was compiled fresh
        if self.cache_misses:
            return "miss"
        if self.cache_hits:
            return "hit"
        return "uncached"


# -- kernel-build attribution ----------------------------------------------

def record_build(name: str, seconds: float, hit: bool,
                 ledger: Optional["CompilationLedger"] = None) -> None:
    """One CUDA source of ``ops._build`` loaded: recorded under the entry
    ``nvcc:<name>`` with cache ``hit`` (its shared library was already
    built) or ``miss`` (``nvcc`` ran), ``seconds`` the build's wall time
    (0 for a hit).  A build that runs inside an instrumented dispatch
    also marks that dispatch's cache column, as a persistent-cache event
    marks the JAX dispatch in flight."""
    rec = current_dispatch()
    if rec is not None:
        if hit:
            rec.cache_hits += 1
        else:
            rec.cache_misses += 1
            rec.backend_compile_s += float(seconds)
    led = ledger if ledger is not None else get_ledger()
    entry = f"nvcc:{name}"
    d = _Dispatch(led, entry)
    if hit:
        d.cache_hits = 1
    else:
        d.cache_misses = 1
        d.backend_compile_s = float(seconds)
    led.record_trace(entry, {"source": {"static": repr(name)}},
                     closure_id=None, dispatch=d)
    led._finalize_dispatch(d, float(seconds))


# -- abstract signatures ---------------------------------------------------

# python scalars as jit sees them: weak-typed 0-d arrays
_PY_DTYPES = ((bool, "bool"), (int, "int32"), (float, "float32"))


def _leaf_sig(leaf) -> List[Any]:
    """One tensor leaf's abstract signature: ``[dtype, shape]`` (dtype
    without the ``torch.`` prefix; a python scalar is a weak-typed 0-d
    value, marked ``weak`` as jit marks it)."""
    dtype = getattr(leaf, "dtype", None)
    shape = getattr(leaf, "shape", None)
    if dtype is not None and shape is not None:
        return [str(dtype).replace("torch.", ""), [int(d) for d in shape]]
    for typ, name in _PY_DTYPES:
        if type(leaf) is typ:
            return [name, [], "weak"]
    return ["py", repr(type(leaf).__name__)]


def _tree_leaves(tree) -> List[Any]:
    """The leaves of nested tuples, lists and dicts (dicts by sorted
    key, as a pytree flattens them); ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _tree_leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=repr)
                for x in _tree_leaves(tree[k])]
    return [tree]


def abstract_signature(args: Sequence[Any],
                       kwargs: Optional[Dict[str, Any]] = None,
                       static_argnums: Sequence[int] = (),
                       static_argnames: Sequence[str] = (),
                       arg_names: Optional[Sequence[str]] = None
                       ) -> Dict[str, Any]:
    """The per-argument abstract signature of one call: each argument
    maps to either ``{"static": repr(value)}`` or
    ``{"leaves": [[dtype, shape], ...]}`` over its tree — plain JSON-able
    python, so snapshots serve without the rest of the package."""
    static = set(int(i) for i in static_argnums)
    names = list(arg_names or ())
    sig: Dict[str, Any] = {}
    for i, a in enumerate(args):
        name = names[i] if i < len(names) else f"arg{i}"
        if i in static:
            sig[name] = {"static": repr(a)}
        else:
            sig[name] = {"leaves": [_leaf_sig(leaf)
                                    for leaf in _tree_leaves(a)]}
    snames = set(static_argnames)
    for k in sorted(kwargs or {}):
        v = (kwargs or {})[k]
        if k in snames:
            sig[k] = {"static": repr(v)}
        else:
            sig[k] = {"leaves": [_leaf_sig(leaf)
                                 for leaf in _tree_leaves(v)]}
    return sig


def format_signature(arg_sig: Any) -> str:
    """Compact human form of ONE argument's signature, e.g.
    ``f32[4,8] i32[4]`` or ``static:3`` — what the ring events and
    ``/compilez`` show as before/after."""
    if not isinstance(arg_sig, dict):
        return repr(arg_sig)
    if "static" in arg_sig:
        return f"static:{arg_sig['static']}"
    parts = []
    for leaf in arg_sig.get("leaves", ()):
        dtype = str(leaf[0]) if leaf else "?"
        shape = leaf[1] if len(leaf) > 1 else None
        short = (dtype.replace("float", "f").replace("uint", "u")
                 .replace("int", "i").replace("bool", "pred")
                 .replace("bfloat", "bf"))
        dims = ",".join(str(d) for d in shape) if isinstance(
            shape, (list, tuple)) else "?"
        # the weak marker must survive into the display form: a
        # weak-vs-committed retrace (python scalar vs device array of
        # the same dtype) would otherwise show an identical
        # before/after pair — an un-actionable "nothing changed" diff
        weak = "(weak)" if "weak" in leaf[2:] else ""
        parts.append(f"{short}[{dims}]{weak}")
    return " ".join(parts) if parts else "(empty)"


def signature_fingerprint(entry: str, signature: Dict[str, Any]) -> str:
    """Stable fingerprint of (entry, abstract signature) — the identity
    two traces share iff jit would have shared their executable (same
    entry, same avals, same statics).  The cross-run join key the
    double-run cache gate compares."""
    blob = json.dumps([entry, signature], sort_keys=True,
                      default=repr).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def diff_signatures(prev: Dict[str, Any], cur: Dict[str, Any]
                    ) -> List[Dict[str, Any]]:
    """The retrace-cause differ: compare two abstract signatures of the
    same entry and name every argument whose signature changed —
    ``[{"arg", "cause", "before", "after"}, ...]`` with cause one of
    ``shape`` / ``dtype`` / ``static_arg`` (``arity`` when an argument
    appeared or vanished).  An **unchanged signature returns []** — no
    retrace cause (the trace was a fresh closure or an explicit
    re-trace, not shape polymorphism)."""
    culprits: List[Dict[str, Any]] = []
    for name in list(prev) + [n for n in cur if n not in prev]:
        a, b = prev.get(name), cur.get(name)
        if a == b:
            continue
        if a is None or b is None:
            cause = "arity"
        elif "static" in (a or {}) or "static" in (b or {}):
            cause = "static_arg"
        else:
            la = a.get("leaves", [])
            lb = b.get("leaves", [])
            if len(la) != len(lb):
                cause = "shape"
            else:
                cause = None
                for xa, xb in zip(la, lb):
                    if xa == xb:
                        continue
                    sa = xa[1] if len(xa) > 1 else None
                    sb = xb[1] if len(xb) > 1 else None
                    if sa != sb:
                        cause = "shape"
                        break
                    cause = "dtype"
                cause = cause or "dtype"
        culprits.append({"arg": name, "cause": cause,
                         "before": format_signature(a),
                         "after": format_signature(b)})
    return culprits


# -- the ledger ------------------------------------------------------------

class CompilationLedger:
    """In-process record of every instrumented trace/compile (captures,
    first eager calls, kernel builds).

    ``registry`` / ``ring`` default to the process singletons resolved
    per use (the ``flightrec.resolve`` rule every producer follows);
    ``max_events_per_entry`` bounds the retained per-entry trace detail
    (counts stay exact forever — flight-ring discipline).
    """

    def __init__(self, registry=None, ring=None,
                 clock: Callable[[], float] = time.perf_counter,
                 max_events_per_entry: int = 64):
        self.registry = registry
        self._ring = ring
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.RLock()
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._max_events = int(max_events_per_entry)
        self._total_traces = 0
        self._total_wall_s = 0.0

    # -- default resolution (per use) ----------------------------------
    def _reg(self):
        from .metrics import get_registry
        return self.registry if self.registry is not None \
            else get_registry()

    @property
    def ring(self):
        from . import flightrec
        return flightrec.resolve(self._ring)

    # -- recording ------------------------------------------------------
    def _entry_state(self, entry: str) -> Dict[str, Any]:
        st = self._entries.get(entry)
        if st is None:
            st = self._entries[entry] = {
                "traces": 0, "retraces": 0, "compiles": 0,
                "cache": {"hit": 0, "miss": 0, "uncached": 0},
                "causes": {},
                # per-closure last signatures: the retrace diff runs
                # against the SAME closure's history (see record_trace)
                "closures": {},
                "last_signature": None, "last_closure": None,
                "last_fingerprint": None,
                "last_retrace": None,
                "compile_wall_s": 0.0, "backend_compile_s": 0.0,
                "last_trace_t_s": None,
                "events": deque(maxlen=self._max_events)}
        return st

    def record_trace(self, entry: str, signature: Dict[str, Any],
                     closure_id: Optional[int] = None,
                     dispatch: Optional[_Dispatch] = None
                     ) -> Dict[str, Any]:
        """The recording primitive: one trace of ``entry`` at
        ``signature``.  Classifies the cause against the entry's
        previous trace, updates counters, and (for signature-change
        causes) appends the ``xla_retrace`` flight event carrying the
        differ's culprit.  Returns the trace event dict."""
        t_s = round(self._clock() - self._t0, 6)
        fp = signature_fingerprint(entry, signature)
        with self._lock:
            st = self._entry_state(entry)
            closures = st["closures"]
            # a RETRACE is a closure re-tracing: the diff must run
            # against THIS closure's own previous signature.  Diffing a
            # fresh closure against another closure's signature is not
            # evidence of shape polymorphism — two differently-shaped
            # engines sharing an entry label (bench builds gpt w1/w8 +
            # llama engines back to back) would otherwise emit
            # storm-class xla_retrace events and false-positive the
            # supervisor, with a "culprit" that never varied within any
            # one closure.
            prev = closures.get(closure_id)
            if not closures and st["last_signature"] is None:
                cause, culprits = "new_entry", []
            elif prev is None:
                cause, culprits = "new_closure", []
            else:
                culprits = diff_signatures(prev, signature)
                if culprits:
                    cause = culprits[0]["cause"]
                    if cause == "arity":
                        cause = "static_arg"
                else:
                    cause = "repeat"
            closures[closure_id] = signature
            # bound the per-closure history: entries whose closures are
            # born per engine instance must not grow without limit in a
            # weeks-long process (counts stay exact forever)
            while len(closures) > 256:
                closures.pop(next(iter(closures)))
            ev: Dict[str, Any] = {
                "entry": entry, "cause": cause, "t_s": t_s,
                "fingerprint": fp,
                "signature": signature}
            if culprits:
                ev["culprits"] = culprits
                ev["culprit"] = culprits[0]["arg"]
            st["traces"] += 1
            st["causes"][cause] = st["causes"].get(cause, 0) + 1
            if cause != "new_entry":
                st["retraces"] += 1
            st["last_signature"] = signature
            st["last_closure"] = closure_id
            st["last_fingerprint"] = fp
            st["last_trace_t_s"] = t_s
            if cause in SIGNATURE_CHANGE_CAUSES:
                st["last_retrace"] = {
                    "cause": cause, "t_s": t_s,
                    "culprit": ev.get("culprit"),
                    "culprits": culprits}
            st["events"].append(ev)
            self._total_traces += 1
        reg = self._reg()
        reg.counter(
            "xla_traces_total",
            help="jit traces of instrumented entries (first compiles "
                 "and retraces alike)").labels(entry=entry).inc()
        reg.counter(
            "xla_retraces_total",
            help="traces by cause: new_entry is the warmup compile, "
                 "shape/dtype/static_arg are signature-change "
                 "retraces, new_closure the per-replica re-jit class"
        ).labels(entry=entry, cause=cause).inc()
        if cause in SIGNATURE_CHANGE_CAUSES:
            top = culprits[0] if culprits else {}
            self.ring.append("xla_retrace", entry=entry, cause=cause,
                             culprit=top.get("arg"),
                             before=top.get("before"),
                             after=top.get("after"))
        if dispatch is not None:
            dispatch.events.append(ev)
        return ev

    def _finalize_dispatch(self, rec: _Dispatch, wall_s: float):
        """Close the books on one instrumented dispatch that traced:
        the wall duration (trace + lower + compile + first execution —
        the honest 'how long did the cold call cost' number), the
        persistent-cache attribution, and the compile counters."""
        if not rec.events:
            return
        label = rec.cache_label
        with self._lock:
            st = self._entry_state(rec.entry)
            st["compiles"] += 1
            st["cache"][label] = st["cache"].get(label, 0) + 1
            st["compile_wall_s"] = round(
                st["compile_wall_s"] + wall_s, 6)
            st["backend_compile_s"] = round(
                st["backend_compile_s"] + rec.backend_compile_s, 6)
            for ev in rec.events:
                ev["wall_s"] = round(wall_s, 6)
                ev["cache"] = label
            self._total_wall_s += wall_s
        reg = self._reg()
        reg.counter(
            "xla_compiles_total",
            help="compiling dispatches by persistent-cache outcome"
        ).labels(entry=rec.entry, cache=label).inc()
        reg.histogram(
            "xla_compile_seconds",
            buckets=_COMPILE_SECONDS_BUCKETS,
            help="wall duration of dispatches that traced (trace + "
                 "lower + compile + first run)").observe(wall_s)

    # -- the instrumenting wrapper --------------------------------------
    def jit(self, fun, entry: str, **kwargs):
        """:func:`instrumented_jit` bound to THIS ledger."""
        return instrumented_jit(fun, entry, ledger=self, **kwargs)

    # -- contract / snapshot surface -------------------------------------
    def total_traces(self) -> int:
        """Monotonic count of every recorded trace — the zero-retrace
        contracts are delta checks over this."""
        with self._lock:
            return self._total_traces

    def compile_wall_s(self) -> float:
        """Total wall seconds spent in tracing dispatches — what
        ``bench.py`` separates out as ``cold_compile_ms``."""
        with self._lock:
            return self._total_wall_s

    def counts(self) -> Dict[str, int]:
        """{entry: traces} snapshot."""
        with self._lock:
            return {e: st["traces"] for e, st in self._entries.items()}

    def entries(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._entries)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-JSON ledger view — what ``/compilez`` serves.  Each
        entry carries its trace/retrace/compile counts, per-cause and
        per-cache tallies, compile seconds, the last trace's signature
        fingerprint, the last *signature-change* retrace (cause +
        the differ's culprit argument), and the bounded recent-trace
        detail."""
        with self._lock:
            entries = {}
            hits = misses = uncached = 0
            retraces = compiles = 0
            for name, st in self._entries.items():
                # events are COPIED per dict: _finalize_dispatch adds
                # wall_s/cache to the live event objects after a slow
                # compile, and a /compilez scrape serializing a shared
                # dict mid-mutation would 500 on "dictionary changed
                # size during iteration"
                entries[name] = {
                    k: ([dict(e) for e in v] if isinstance(v, deque)
                        else dict(v) if isinstance(v, dict) else v)
                    for k, v in st.items() if k != "closures"}
                hits += st["cache"].get("hit", 0)
                misses += st["cache"].get("miss", 0)
                uncached += st["cache"].get("uncached", 0)
                retraces += st["retraces"]
                compiles += st["compiles"]
            return {
                "kind": "compilation",
                "entries": entries,
                "totals": {"traces": self._total_traces,
                           "retraces": retraces,
                           "compiles": compiles,
                           "cache_hits": hits,
                           "cache_misses": misses,
                           "cache_uncached": uncached,
                           "compile_wall_s": round(self._total_wall_s,
                                                   6)},
                "uptime_s": round(self._clock() - self._t0, 3)}

    def dump(self, path: str) -> str:
        """Write the snapshot as one JSON document (atomic replace, the
        flight-ring dump discipline) — what the double-run CI gate
        reads to assert run 2's serving compiles were cache-HIT."""
        snap = self.snapshot()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=2, default=repr)
            f.write("\n")
        os.replace(tmp, path)
        return path


# -- instrumentation --------------------------------------------------------

class Closure:
    """One instrumented closure: an entry label, its ledger (None: the
    process ledger, resolved per record so a ``set_ledger`` swap
    follows), its closure id and the fingerprints of the signatures it
    has recorded.  Several callables may share one: a paged engine's
    decode entry is two graphs (a graph cannot branch where the JAX jit
    holds a ``lax.cond``), and the JAX jit traces once for both."""

    __slots__ = ("entry", "ledger", "closure_id", "seen", "last")

    def __init__(self, entry: str, ledger=None):
        self.entry = str(entry)
        self.ledger = ledger
        self.closure_id = next(_closure_ids)
        self.seen: set = set()
        self.last: Optional[Dict[str, Any]] = None

    def resolve(self) -> "CompilationLedger":
        return self.ledger if self.ledger is not None else get_ledger()

    def fresh(self, signature: Dict[str, Any]) -> bool:
        """Whether ``signature`` is one this closure has not recorded."""
        return signature_fingerprint(self.entry, signature) not in self.seen

    def record(self, signature: Dict[str, Any], wall_s: float,
               cache: str = "uncached") -> Optional[Dict[str, Any]]:
        """One trace of this closure at ``signature`` taking ``wall_s``
        (a capture's, or a first eager call's), unless the signature was
        recorded before: then nothing, and None."""
        fp = signature_fingerprint(self.entry, signature)
        if fp in self.seen:
            return None
        led = self.resolve()
        d = _Dispatch(led, self.entry)
        if cache == "hit":
            d.cache_hits = 1
        elif cache == "miss":
            d.cache_misses = 1
        ev = led.record_trace(self.entry, signature,
                              closure_id=self.closure_id, dispatch=d)
        led._finalize_dispatch(d, float(wall_s))
        self.seen.add(fp)
        self.last = signature
        return ev

    def refuse(self, signature: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Record a signature a shape-static callable refuses: through the
        differ against this closure's last signature (cause ``shape`` /
        ``dtype``, culprit named, the ``xla_retrace`` ring event), no
        compile counted.  Returns the differ's culprits."""
        led = self.resolve()
        ev = led.record_trace(self.entry, signature,
                              closure_id=self.closure_id)
        if self.last is not None:
            # nothing was compiled: the closure keeps the signature it
            # holds, and the next refusal diffs against that again
            with led._lock:
                led._entries[self.entry]["closures"][self.closure_id] = \
                    self.last
        return list(ev.get("culprits", ()))


def culprit_text(culprits: Sequence[Dict[str, Any]]) -> str:
    """The differ's verdict in words: ``ids (shape): i32[4,32] ->
    i32[4,48]``, one per culprit."""
    return "; ".join(f"{c['arg']} ({c['cause']}): {c['before']} -> "
                     f"{c['after']}" for c in culprits)


def instrumented_jit(fun, entry: str, *, ledger=None,
                     arg_names: Optional[Sequence[str]] = None,
                     static_argnums: Sequence[int] = (),
                     static_argnames: Sequence[str] = (),
                     closure: Optional[Closure] = None):
    """Put ``fun`` under the ledger as ``entry``.

    - A ``_graph.CapturedFn`` (or ``CapturedStep``) is instrumented in
      place and returned: it records at its capture on the card, at its
      first call on the CPU (see the module doc).  ``closure`` shares one
      :class:`Closure` between several graphs of one entry.
    - Any other callable returns a wrapper that computes the abstract
      signature of each call and records the first call at each new one,
      timed (the call's wall duration is the compile column's); later
      calls at a recorded signature record nothing.

    ``arg_names`` labels the positional arguments for the retrace differ
    (falls back to the function's own signature, then ``arg0..``).  The
    wrapper carries ``entry``, ``closure_id`` and ``closure``.
    """
    import functools
    import inspect

    clo = closure if closure is not None else Closure(entry, ledger)
    if hasattr(fun, "instrument"):
        fun.instrument(clo)
        return fun
    sargs = tuple(int(i) for i in static_argnums)
    snames = tuple(static_argnames)
    if arg_names is not None:
        names: Sequence[str] = tuple(arg_names)
    else:
        try:
            names = tuple(inspect.signature(fun).parameters)
        except (TypeError, ValueError):
            names = ()

    @functools.wraps(fun)
    def wrapped(*args, **kwargs):
        sig = abstract_signature(args, kwargs, static_argnums=sargs,
                                 static_argnames=snames, arg_names=names)
        if not clo.fresh(sig):
            return fun(*args, **kwargs)
        led = clo.resolve()
        rec = _Dispatch(led, clo.entry)
        st = _stack()
        st.append(rec)
        t0 = led._clock()
        try:
            return fun(*args, **kwargs)
        finally:
            dt = led._clock() - t0
            try:
                st.remove(rec)
            except ValueError:
                pass
            cache = ("miss" if rec.cache_misses
                     else "hit" if rec.cache_hits else "uncached")
            clo.record(sig, dt, cache=cache)

    wrapped.entry = clo.entry
    wrapped.closure_id = clo.closure_id
    wrapped.closure = clo
    return wrapped


# -- process singleton ------------------------------------------------------

_process_ledger = CompilationLedger()


def get_ledger() -> CompilationLedger:
    """The process-wide default ledger (every instrumented entry without
    an explicit ledger records here; ``/compilez`` serves it)."""
    return _process_ledger


def set_ledger(ledger: CompilationLedger) -> CompilationLedger:
    global _process_ledger
    prev, _process_ledger = _process_ledger, ledger
    return prev
