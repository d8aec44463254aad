"""Device-time truth: parse the Chrome trace ``torch.profiler`` writes
and attribute a step's DEVICE time — measured, not inferred.

Counterpart of ``apex_tpu/observability/timeline.py``.
``observability.steptime`` decomposes a train step by host wall-clock
differencing; this module measures instead, from the ``trace.json`` that
``utils.profiler`` writes into each capture's own directory: total device
busy time, per-kernel top-k, compute vs collective vs gap split, and a
*measured* ``overlap_fraction`` from actual kernel-interval overlap.
:func:`classify_kernel`, :func:`merge_intervals`, :func:`overlap_us`,
:func:`attribute_timeline` and :func:`profile_record` are the JAX
package's; :func:`device_events` reads torch's trace format:

- **a card capture**: the ``cat`` ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events (CUPTI's, graph replays included), laned by
  device and stream.  A card capture with no kernel event raises: it
  does not fall back to host events, which would attribute launch time
  as device time;
- **a CPU capture** (no device): the top-level ``cpu_op`` events of each
  host thread (or of one, ``host_tid``) — the operators the CPU ran,
  not their nested calls.

NCCL kernels (``ncclDevKernel_*``, ``ncclKernel_*``) and the c10d
operators classify as collectives; the port's own kernels (``ops/csrc``)
and everything else as compute.  ``modules`` keeps the events inside a
named range (``utils.profiler.nvtx_range``; on the card the
``gpu_user_annotation`` rows, on the CPU the ``user_annotation`` rows)
whose name contains one of the given substrings — the counterpart of the
JAX package's ``hlo_module`` filter.  Timestamps and durations are
microseconds.

Stdlib-only at module scope (gzip + json); torch is imported by the
capture helpers alone.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["COLLECTIVE_PATTERNS", "PROFILE_FIELDS", "classify_kernel",
           "find_trace_file", "load_trace", "device_events",
           "merge_intervals", "overlap_us", "attribute_timeline",
           "analyze_capture", "profile_record", "capture",
           "make_profiler"]

# substrings (lowercase) of kernel and operator names that are
# cross-device communication: NCCL's kernels, the c10d operators of a CPU
# (gloo) capture, and the JAX package's HLO names, kept so its synthetic
# traces classify alike.
COLLECTIVE_PATTERNS = ("ncclkernel", "nccldevkernel", "nccl:",
                       "all-reduce", "allreduce", "all_reduce",
                       "all-gather", "allgather", "all_gather",
                       "reduce-scatter", "reducescatter", "reduce_scatter",
                       "collective-permute", "collectivepermute",
                       "all-to-all", "alltoall", "all_to_all",
                       "collective-broadcast", "psum", "ppermute",
                       "c10d::broadcast")

# the device rows of a card capture (CUPTI activity categories)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# the timing fields every ``kind: profile`` record must carry
# (exporters.validate_profile_record keys its checks off these; they
# are all in MILLISECONDS except the fraction)
PROFILE_FIELDS = ("span_ms", "device_busy_ms", "compute_ms",
                  "collective_ms", "gap_ms", "overlap_ms",
                  "measured_overlap_fraction")

_TRACE_SUFFIXES = (".trace.json.gz", ".trace.json", "trace.json")


def classify_kernel(name: str) -> str:
    """``"collective"`` or ``"compute"`` for one kernel or operator
    name."""
    low = str(name).lower()
    for pat in COLLECTIVE_PATTERNS:
        if pat in low:
            return "collective"
    return "compute"


def find_trace_file(logdir: str) -> str:
    """Resolve the trace file of the NEWEST capture under ``logdir`` (a
    direct ``*trace.json[.gz]`` path passes through).  Searches ``logdir``
    itself (``utils.profiler`` writes ``trace.json`` there) and one and
    two levels below; raises ``FileNotFoundError`` when no trace file
    exists — the caller should be handing a unique per-capture directory
    (``utils.profiler.profile()`` yields one), so "newest" is normally
    "the only one"."""
    if os.path.isfile(logdir):
        return logdir
    candidates: List[str] = []
    for root in (logdir, os.path.join(logdir, "plugins", "profile")):
        for path in glob.glob(os.path.join(glob.escape(root), "*")) \
                + glob.glob(os.path.join(glob.escape(root), "*", "*")):
            if os.path.isfile(path) and path.endswith(_TRACE_SUFFIXES):
                candidates.append(path)
    if not candidates:
        raise FileNotFoundError(
            f"no trace.json under {logdir!r} — was the capture "
            f"stopped (profiler.stop_profile) before parsing?")
    # newest capture wins; mtime first, path as the deterministic tie
    return max(candidates, key=lambda p: (os.path.getmtime(p), p))


def load_trace(path: str) -> Dict[str, Any]:
    """Load one Chrome-trace JSON document (gzipped or plain)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents "
                         f"list)")
    return doc


def _inside(e, spans) -> bool:
    return any(s0 <= e[0] and e[1] <= s1 for s0, s1 in spans)


def device_events(doc: Dict[str, Any],
                  modules: Optional[Iterable[str]] = None,
                  device: Optional[str] = None,
                  host_tid: Optional[int] = None
                  ) -> List[Dict[str, Any]]:
    """Extract the device's executions from one torch trace document (see
    the module doc): on the card its kernel, memcpy and memset events; on
    the CPU the top-level ``cpu_op`` events of each host thread (of
    ``host_tid`` alone when given).  ``device`` (``"cuda"`` / ``"cpu"``)
    says which the capture was; None decides from the document (device
    rows, or the ``deviceProperties`` a CUDA capture records).  A card
    capture with no device row raises ``ValueError``."""
    evs = [e for e in doc.get("traceEvents", [])
           if isinstance(e, dict) and e.get("ph") == "X"]
    on_card = any(e.get("cat") in DEVICE_CATEGORIES for e in evs)
    if device is None:
        device = "cuda" if (on_card or doc.get("deviceProperties")) \
            else "cpu"
    mods = tuple(modules) if modules is not None else None

    def ival(e):
        try:
            ts = float(e["ts"])
            return ts, ts + max(float(e.get("dur", 0.0)), 0.0)
        except (KeyError, TypeError, ValueError):
            return None

    if device == "cuda":
        rows = [e for e in evs if e.get("cat") in DEVICE_CATEGORIES]
        if not rows:
            raise ValueError(
                "a card capture with no kernel, memcpy or memset event: "
                "the profiler did not trace the device (CUPTI), and host "
                "events are no device time")
        ann_cat = "gpu_user_annotation"
    else:
        rows = [e for e in evs if e.get("cat") == "cpu_op"
                and (host_tid is None or e.get("tid") == host_tid)]
        # top level: not inside another cpu_op of the same thread
        by_lane: Dict[Any, List[Tuple[float, float]]] = {}
        for e in sorted(rows, key=lambda e: (float(e.get("ts", 0)),
                                             -float(e.get("dur", 0)))):
            iv = ival(e)
            if iv is None:
                continue
            lane = (e.get("pid"), e.get("tid"))
            tops = by_lane.setdefault(lane, [])
            if tops and iv[1] <= tops[-1][1]:
                e["_nested"] = True
                continue
            tops.append(iv)
        rows = [e for e in rows if not e.pop("_nested", False)]
        ann_cat = "user_annotation"
    spans = None
    if mods is not None:
        spans = [ival(e) for e in evs
                 if e.get("cat") == ann_cat
                 and any(m in str(e.get("name", "")) for m in mods)]
        spans = [s for s in spans if s is not None]
    out: List[Dict[str, Any]] = []
    for e in rows:
        iv = ival(e)
        if iv is None or (spans is not None and not _inside(iv, spans)):
            continue
        name = e.get("name") if isinstance(e.get("name"), str) else "?"
        args = e.get("args") if isinstance(e.get("args"), dict) else {}
        if device == "cuda":
            lane = (args.get("device", e.get("pid")),
                    args.get("stream", e.get("tid")))
        else:
            lane = (e.get("pid"), e.get("tid"))
        out.append({"name": name, "op": name, "module": None,
                    "ts": iv[0], "dur": iv[1] - iv[0], "lane": lane,
                    "kind": classify_kernel(name)})
    return out


def merge_intervals(intervals: Iterable[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Union of half-open intervals as a sorted disjoint list."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    out: List[Tuple[float, float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_us(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> float:
    """Total overlap between two MERGED interval lists (two-pointer
    sweep)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


_SUFFIX_RE = re.compile(r"\.\d+$")


def _kernel_base(name: str) -> str:
    """Aggregate key for top-k: strip XLA's ``.N`` instance suffix so
    ``dot.1`` / ``dot.3`` report as one ``dot`` line."""
    return _SUFFIX_RE.sub("", name)


def attribute_timeline(events: List[Dict[str, Any]], top_k: int = 10
                       ) -> Dict[str, Any]:
    """Per-capture device-time attribution over extracted events.

    All times are the UNION over lanes (a kernel running on 8 virtual
    devices at once counts its wall extent once — the schedule view,
    matching what host differencing tries to estimate):

    - ``span_ms``: first kernel start to last kernel end;
    - ``device_busy_ms``: union of all kernel intervals;
    - ``compute_ms`` / ``collective_ms``: per-class unions;
    - ``gap_ms``: ``span - busy`` — scheduling stall / host time
      between kernels;
    - ``overlap_ms``: time covered by BOTH a compute and a collective
      interval — the measured comm/compute overlap;
    - ``measured_overlap_fraction``: ``overlap / collective`` (0.0
      with no collectives) — the device-timeline counterpart of
      ``steptime``'s differenced ``overlap_fraction``.
    """
    comp = merge_intervals((e["ts"], e["ts"] + e["dur"])
                           for e in events if e["kind"] == "compute")
    coll = merge_intervals((e["ts"], e["ts"] + e["dur"])
                           for e in events if e["kind"] == "collective")
    busy = merge_intervals([(s, e) for s, e in comp] +
                           [(s, e) for s, e in coll])
    busy_us = sum(e - s for s, e in busy)
    comp_us = sum(e - s for s, e in comp)
    coll_us = sum(e - s for s, e in coll)
    if busy:
        span_us = (max(e for _, e in busy) - min(s for s, _ in busy))
    else:
        span_us = 0.0
    ovl_us = overlap_us(comp, coll)
    frac = (ovl_us / coll_us) if coll_us > 0 else 0.0

    agg: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for e in events:
        key = (_kernel_base(e["name"]), e["kind"])
        a = agg.setdefault(key, {"name": key[0], "kind": key[1],
                                 "count": 0, "total_us": 0.0})
        a["count"] += 1
        a["total_us"] += e["dur"]
    top = sorted(agg.values(), key=lambda a: -a["total_us"])[:top_k]

    def ms(us):
        return round(us / 1e3, 4)

    return {"span_ms": ms(span_us),
            "device_busy_ms": ms(busy_us),
            "compute_ms": ms(comp_us),
            "collective_ms": ms(coll_us),
            "gap_ms": ms(max(span_us - busy_us, 0.0)),
            "overlap_ms": ms(ovl_us),
            "measured_overlap_fraction": round(min(max(frac, 0.0), 1.0),
                                               4),
            "kernel_count": len(events),
            "lane_count": len({e["lane"] for e in events}),
            "top_kernels": [{"name": a["name"], "kind": a["kind"],
                             "count": a["count"],
                             "total_ms": ms(a["total_us"])}
                            for a in top]}


def analyze_capture(logdir: str,
                    modules: Optional[Iterable[str]] = None,
                    steps: int = 1, top_k: int = 10,
                    device: Optional[str] = None,
                    host_tid: Optional[int] = None) -> Dict[str, Any]:
    """Find + parse the capture under ``logdir`` and attribute it.
    ``steps`` divides the time fields (a capture of N identical steps
    reports per-step ms; the fraction and counts stay whole-capture),
    recorded on the result as ``steps``."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    path = find_trace_file(logdir)
    att = attribute_timeline(device_events(load_trace(path),
                                           modules=modules, device=device,
                                           host_tid=host_tid),
                             top_k=top_k)
    if steps > 1:
        for k in ("span_ms", "device_busy_ms", "compute_ms",
                  "collective_ms", "gap_ms", "overlap_ms"):
            att[k] = round(att[k] / steps, 4)
        for a in att["top_kernels"]:
            a["total_ms"] = round(a["total_ms"] / steps, 4)
    att["steps"] = steps
    att["trace_path"] = path
    return att


def profile_record(attribution: Dict[str, Any], metric: str,
                   **extra) -> Dict[str, Any]:
    """Shape one attribution as a ``kind: profile`` record body (the
    caller routes it through ``JsonlExporter.enrich`` for the
    envelope); ``extra`` lands verbatim (e.g. ``kv_waste_bytes`` /
    ``kv_utilization`` on serving profiles)."""
    return {"kind": "profile", "metric": metric, **attribution, **extra}


# -- capture helpers (the only torch-touching surface, imported lazily) --

def _blocked_fetch(out) -> None:
    # the steptime barrier discipline: a D2H fetch cannot complete
    # before the work queued ahead of it finishes, so every kernel the
    # window launched lands INSIDE the window; then every stream drains
    import torch
    from .steptime import _block
    _block(out)
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def capture(fn: Callable, *args, iters: int = 1,
            logdir: Optional[str] = None,
            modules: Optional[Iterable[str]] = None,
            top_k: int = 10) -> Dict[str, Any]:
    """Run ``fn(*args)`` ``iters`` times inside a fresh profiler window
    (unique per-capture directory via ``utils.profiler.profile``) with
    a blocked fetch before the window closes, then parse and return the
    per-step attribution: the card's kernels when there is a card, else
    the calling thread's top-level operators.  The caller should have
    warmed ``fn`` first (a ``make_step`` step captured) — a cold call
    captures the warm-up and the capture, not the step."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    import threading

    import torch

    from ..utils import profiler
    out = None
    with profiler.profile(*(() if logdir is None else (logdir,))) as cap:
        for _ in range(iters):
            out = fn(*args)
        _blocked_fetch(out)
    on_card = torch.cuda.is_available()
    return analyze_capture(cap, modules=modules, steps=iters,
                           top_k=top_k,
                           device="cuda" if on_card else "cpu",
                           host_tid=(None if on_card
                                     else threading.get_native_id()))


def make_profiler(subject: str = "live_process",
                  default_duration_ms: float = 250.0,
                  max_duration_ms: float = 2000.0,
                  logdir: Optional[str] = None,
                  top_k: int = 10,
                  cleanup: bool = True) -> Callable:
    """Build the on-demand capture hook ``/profilez`` calls: a
    one-optional-arg callable that opens a BOUNDED profiler window on
    the live process (whatever the serving/training loop launches
    during it is what gets attributed: on the card its kernels, on the
    CPU every thread's top-level operators), parses it, and returns the
    ``kind: profile`` record body.  Raises ``server.ProfileInFlight``
    when a profiler window is already open (ours or a foreign
    ``torch.profiler``), which the endpoint maps to HTTP 409.
    ``cleanup=True`` (the default here, unlike bench/test captures whose
    dirs are the artifact) deletes the capture directory after parsing — a monitor scraping ``/profilez``
    periodically must not grow /tmp without bound.

    The hook runs on the server's thread while the process goes on
    launching.  The window opens and closes only between the holds of
    ``utils.profiler.launch_guard`` (every engine method that launches,
    every graph capture and replay), with the card drained first
    (``utils.profiler.start_profile``/``stop_profile``): opening or
    closing the profiler while another thread was replaying a CUDA graph
    hung a serving process on the card."""
    if max_duration_ms <= 0 or default_duration_ms <= 0:
        raise ValueError("durations must be > 0")

    def _capture(duration_ms: Optional[float] = None) -> Dict[str, Any]:
        import shutil
        import time as _time

        from ..utils import profiler
        from .server import ProfileInFlight
        if profiler.profiling_active():
            raise ProfileInFlight(
                "a profiler trace window is already open in this "
                "process")
        want = float(duration_ms) if duration_ms is not None \
            else float(default_duration_ms)
        if want != want:                   # NaN: the clamp would pass it
            raise ValueError("duration_ms must be a finite number")
        bounded = min(max(want, 1.0), float(max_duration_ms))
        try:
            with profiler.profile(
                    *(() if logdir is None else (logdir,))) as cap:
                _time.sleep(bounded / 1e3)
        except RuntimeError as e:
            # a foreign trace raced us between the check and the start
            raise ProfileInFlight(str(e)) from e
        if profiler.profiling_active():
            # an in-library window opened between the check and our
            # profile(): we JOINED it (refcount semantics), our stop
            # was a no-op, and no trace file exists yet — that is an
            # in-flight capture, not a parse error.  ``cap`` is the
            # OUTER window's directory here: never delete it.
            raise ProfileInFlight(
                "the capture window joined another profile() in "
                "flight; retry once it closes")
        try:
            att = analyze_capture(cap, top_k=top_k)
        except FileNotFoundError as e:
            # the window was ours and closed, yet no trace file —
            # treat as a racing capture; the dir holds nothing worth
            # keeping either way
            if cleanup:
                shutil.rmtree(cap, ignore_errors=True)
            raise ProfileInFlight(str(e)) from e
        except Exception:
            # malformed trace & co: don't leak the capture dir on the
            # way to the 500
            if cleanup:
                shutil.rmtree(cap, ignore_errors=True)
            raise
        if cleanup:
            att.pop("trace_path", None)    # about to dangle
            shutil.rmtree(cap, ignore_errors=True)
        return profile_record(att, metric=subject,
                              duration_ms=round(bounded, 3))

    return _capture
