"""Named ranges and profiler windows, and ``AverageMeter``.

Counterpart of ``apex_tpu/utils/profiler.py``.  The JAX package annotates
twice: a ``jax.named_scope`` (names the device ops) and a host trace
annotation.  Here a range is a ``torch.profiler.record_function`` range
(host and device timelines of ``torch.profiler``) and, when a GPU is
present, an NVTX range (``torch.cuda.nvtx``, what the reference Apex
pushes).  ``start_profile``/``stop_profile`` open and close a
``torch.profiler`` window, the ``--prof`` window of the imagenet example,
and write a chrome trace (``trace.json``) into the window's own capture
directory.

A window may be opened and closed from another thread than the one that
launches work (the introspection server's ``/profilez``).  Starting or
stopping the profiler while another thread is inside a CUDA graph's
replay or capture can hang the process, so the two are kept apart: code
that launches work holds :func:`launch_guard` (the engines' ``step`` and
``warmup``, every captured graph's capture and replay), and the window
opens and closes only while no such hold is in flight, after draining
the card.  A loop that launches outside those holds can take
``launch_guard()`` itself.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import tempfile
import threading
from typing import Optional

import torch

__all__ = ["range_push", "range_pop", "nvtx_range", "annotate",
           "start_profile", "stop_profile", "profile", "profiling_active",
           "current_capture_dir", "last_capture_dir", "launch_guard",
           "AverageMeter"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def range_push(name: str) -> int:
    """Open a named range (``torch.cuda.nvtx.range_push``'s shape).
    Returns the new nesting depth."""
    rec = torch.profiler.record_function(name)
    rec.__enter__()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    _stack().append((rec, nvtx))
    return len(_stack())


def range_pop() -> int:
    """Close the innermost range."""
    stack = _stack()
    if not stack:
        raise RuntimeError("range_pop() without matching range_push()")
    rec, nvtx = stack.pop()
    if nvtx:
        torch.cuda.nvtx.range_pop()
    rec.__exit__(None, None, None)
    return len(stack)


@contextlib.contextmanager
def nvtx_range(name: str):
    """Context-manager form; closes the range on an exception too."""
    range_push(name)
    try:
        yield
    finally:
        range_pop()


def annotate(name: Optional[str] = None):
    """Decorator: run the function under a named range."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with nvtx_range(label):
                return fn(*args, **kwargs)
        return wrapped
    return deco


class _LaunchGate:
    """Shared holds for code that launches work, exclusive holds for a
    profiler window's opening and closing.  A waiting exclusive hold
    stops new shared holds, so a steady stream of launches cannot starve
    it; a thread's shared holds nest."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0
        self._tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    @contextlib.contextmanager
    def shared(self):
        depth = self._depth()
        if depth == 0:
            with self._cond:
                while self._exclusive or self._waiting:
                    self._cond.wait()
                self._shared += 1
        self._tls.depth = depth + 1
        try:
            yield
        finally:
            self._tls.depth = depth
            if depth == 0:
                with self._cond:
                    self._shared -= 1
                    if not self._shared:
                        self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        if self._depth():
            # this thread is inside a launch: its own work is not in flight
            # while it runs this, and it cannot wait for itself
            yield
            return
        with self._cond:
            self._waiting += 1
            try:
                while self._exclusive or self._shared:
                    self._cond.wait()
            finally:
                self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


_GATE = _LaunchGate()


def launch_guard():
    """Context manager held around work that launches on the card (see
    the module doc): a profiler window does not open or close inside
    it.  Nested holds on one thread are free."""
    return _GATE.shared()


def _drain() -> None:
    """Wait for every card of the process to finish what it was given
    (nothing to do where CUDA was never initialised)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def _default_logdir() -> str:
    return os.path.join(tempfile.gettempdir(), "apex_tpu_torch_profile")


# One window a process, refcounted: a nested start joins the open window
# and only the outermost stop closes it.  Each outermost window captures
# into its own ``capture_<pid>_<n>`` directory.
_trace_lock = threading.Lock()
_trace_depth = 0
_profiler: Optional[torch.profiler.profile] = None
_capture_dir: Optional[str] = None
_capture_seq = itertools.count()


def start_profile(logdir: Optional[str] = None) -> str:
    """Open a ``torch.profiler`` window (CPU, and CUDA when there is a
    GPU).  Reentrant: a nested call joins the open window and returns its
    directory.  Returns the window's capture directory, a fresh
    subdirectory of ``logdir`` (default: ``apex_tpu_torch_profile`` in
    the temporary directory).  It opens once no :func:`launch_guard` hold
    is in flight and the card is drained."""
    global _trace_depth, _capture_dir, _profiler
    with _GATE.exclusive(), _trace_lock:
        if _trace_depth == 0:
            _drain()
            cap = os.path.join(
                logdir or _default_logdir(),
                f"capture_{os.getpid()}_{next(_capture_seq):04d}")
            os.makedirs(cap, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            try:
                prof.start()
            except BaseException:
                os.rmdir(cap)
                raise
            _profiler, _capture_dir = prof, cap
        _trace_depth += 1
        return _capture_dir


def stop_profile() -> Optional[str]:
    """Close the window: only the outermost matching call stops the
    profiler, writes ``trace.json`` and returns the capture directory; an
    inner or unmatched call returns None.  The outermost stop waits, as
    the start does, for the launches in flight and drains the card, so the
    window holds all the work launched in it."""
    global _trace_depth, _profiler
    with _GATE.exclusive(), _trace_lock:
        if _trace_depth == 0:
            return None
        _trace_depth -= 1
        if _trace_depth:
            return None
        _drain()
        prof, _profiler = _profiler, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(_capture_dir, "trace.json"))
        return _capture_dir


def profiling_active() -> bool:
    """True while a window is open (at any nesting depth)."""
    with _trace_lock:
        return _trace_depth > 0


def current_capture_dir() -> Optional[str]:
    """The open window's capture directory (None when none is open)."""
    with _trace_lock:
        return _capture_dir if _trace_depth > 0 else None


def last_capture_dir() -> Optional[str]:
    """The most recent window's capture directory, still set after
    ``stop_profile`` (when its trace file exists); None before the first
    window."""
    with _trace_lock:
        return _capture_dir


@contextlib.contextmanager
def profile(logdir: Optional[str] = None):
    """Context-manager window; a nested one joins the outer window.
    Yields the capture directory, whose ``trace.json`` exists after the
    outermost block exits."""
    cap = start_profile(logdir)
    try:
        yield cap
    finally:
        stop_profile()


class AverageMeter:
    """Running average (the reference's examples/imagenet/main_amp.py:
    415-430), for the examples' loss and throughput lines."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
