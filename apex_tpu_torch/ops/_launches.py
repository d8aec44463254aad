"""The wrappers' launch counts, updated under one lock, and the hook
through which a cost count sees the wrappers.

A serving fleet steps its replicas from a thread pool, and every wrapper
and every graph replay adds to the same counts: a bare ``+=`` on a
shared attribute is a read-modify-write that loses an update when two
threads interleave.  The lock is host-side only; a captured replay's
device time does not see it.

A cost count (``observability.costmodel.count_cost``) prices a step by the
aten operators it dispatches, which a ``ctypes`` launch never reaches.
So each wrapper is :func:`priced`: while a count runs, the call goes
through the count's hook (``HOOK``), which prices it and runs it.  With no
count running, a priced wrapper costs one test.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Optional

LOCK = threading.Lock()

# ``hook(wrapper, body, cost, args, kwargs)`` -> the call's result; set by
# observability.costmodel while a count runs
HOOK: Optional[Callable] = None


def count(wrapper, n: int = 1) -> None:
    """Add ``n`` launches to ``wrapper``'s count."""
    with LOCK:
        wrapper.launches += n


def priced(cost: Optional[Callable[..., Dict[str, object]]] = None):
    """Decorate a kernel wrapper for the cost count.  By default the count
    prices the wrapper as its plain version (the body run on meta tensors);
    ``cost(*args, **kwargs)`` declares a count of its own instead, for a
    kernel whose convention is not its plain version's: ``flops``,
    ``transcendentals``, ``bytes``, for a matmul ``matmul_flops`` and
    ``matmul_dtype``, and ``prim``, the entry of ``flops_by_prim`` it is
    counted under (default ``kernel:<wrapper>``)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            hook = HOOK
            if hook is None:
                return fn(*args, **kwargs)
            return hook(wrapper, fn, cost, args, kwargs)
        return wrapper
    return deco
