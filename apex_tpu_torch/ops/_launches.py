"""The wrappers' launch counts, updated under one lock.

A serving fleet steps its replicas from a thread pool, and every wrapper
and every graph replay adds to the same counts: a bare ``+=`` on a
shared attribute is a read-modify-write that loses an update when two
threads interleave.  The lock is host-side only; a captured replay's
device time does not see it.
"""

from __future__ import annotations

import threading

LOCK = threading.Lock()


def count(wrapper, n: int = 1) -> None:
    """Add ``n`` launches to ``wrapper``'s count."""
    with LOCK:
        wrapper.launches += n
