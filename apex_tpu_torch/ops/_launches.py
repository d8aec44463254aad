"""The wrappers' launch counts, updated under one lock, and the hook
through which a cost count sees the wrappers.

A serving fleet steps its replicas from a thread pool, and every wrapper
and every graph replay adds to the same counts: a bare ``+=`` on a
shared attribute is a read-modify-write that loses an update when two
threads interleave.  The lock is host-side only; a captured replay's
device time does not see it.

A cost count (``observability.costmodel.count_cost``) prices a step by the
aten operators it dispatches, which a ``ctypes`` launch never reaches, and
the graph analysis (``analysis.graphs``, ``analysis.pallas_lint``) records
each launch as one node.  So each wrapper is :func:`priced`: while a
hook is installed (:func:`add_hook`), the call goes through ``HOOK``,
which runs the installed hooks in order, each around the next, the last
around the call itself.  With no hook installed, or inside
:func:`suspended`, a priced wrapper costs one test.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, List, Optional, Tuple

LOCK = threading.Lock()

# ``hook(wrapper, body, cost, args, kwargs)`` -> the call's result: each
# hook runs ``body`` (the next hook, or the call) itself
HOOKS: List[Callable] = []
# the chain of HOOKS while any is installed, else None
HOOK: Optional[Callable] = None


def _chain(wrapper, body, cost, args, kwargs):
    hooks = list(HOOKS)

    def call(i, a, kw):
        if i == len(hooks):
            return body(*a, **kw)
        return hooks[i](wrapper, lambda *a2, **kw2: call(i + 1, a2, kw2),
                        cost, a, kw)
    return call(0, args, kwargs)


def add_hook(hook: Callable) -> None:
    """Install ``hook`` after those installed (under ``LOCK``)."""
    global HOOK
    with LOCK:
        HOOKS.append(hook)
        HOOK = _chain


def remove_hook(hook: Callable) -> None:
    """Uninstall one installation of ``hook``."""
    global HOOK
    with LOCK:
        HOOKS.remove(hook)
        if not HOOKS:
            HOOK = None


@contextlib.contextmanager
def suspended():
    """No hook for the block, as with none installed (a timed loop); the
    hooks installed before it are back after it."""
    global HOOK
    with LOCK:
        saved = list(HOOKS)
        HOOKS.clear()
        HOOK = None
    try:
        yield
    finally:
        with LOCK:
            HOOKS[:0] = saved
            HOOK = _chain if HOOKS else None


def count(wrapper, n: int = 1) -> None:
    """Add ``n`` launches to ``wrapper``'s count."""
    with LOCK:
        wrapper.launches += n


def priced(cost: Optional[Callable[..., Dict[str, object]]] = None,
           writes: Tuple[str, ...] = ()):
    """Decorate a kernel wrapper for the cost count.  By default the count
    prices the wrapper as its plain version (the body run on meta tensors);
    ``cost(*args, **kwargs)`` declares a count of its own instead, for a
    kernel whose convention is not its plain version's: ``flops``,
    ``transcendentals``, ``bytes``, for a matmul ``matmul_flops`` and
    ``matmul_dtype``, and ``prim``, the entry of ``flops_by_prim`` it is
    counted under (default ``kernel:<wrapper>``).

    ``writes`` names the tensor parameters the kernel writes; every other
    operand it only reads.  A ``ctypes`` launch moves no version counter,
    so this table is the one account of what a launch writes (the graph
    analysis's state facts and the launch lint both read ``.writes``)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            hook = HOOK
            if hook is None:
                return fn(*args, **kwargs)
            return hook(wrapper, fn, cost, args, kwargs)
        wrapper.writes = tuple(writes)
        return wrapper
    return deco
