"""Hand-written Hopper kernels and their wrappers.

``multi_tensor`` (scale, axpby, l2norm) and ``adam`` wrap the CUDA C++
sources of ``csrc/``, which ``_build`` compiles with ``nvcc`` for sm_90a
at first launch and loads with ``ctypes``.  Importing this package
builds nothing.
"""

from __future__ import annotations

from typing import Dict

from . import adam, multi_tensor
from .adam import fused_adam
from .multi_tensor import (multi_tensor_axpby, multi_tensor_l2norm,
                           multi_tensor_scale)

__all__ = ["fused_adam", "multi_tensor_scale", "multi_tensor_axpby",
           "multi_tensor_l2norm", "WRAPPERS", "launch_counts",
           "reset_launch_counts"]

# every kernel wrapper of the port, by name
WRAPPERS = {f.__name__: f for f in (multi_tensor_scale, multi_tensor_axpby,
                                    multi_tensor_l2norm, fused_adam)}


def launch_counts() -> Dict[str, int]:
    """How many times each wrapper has launched its kernel."""
    return {name: f.launches for name, f in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for f in WRAPPERS.values():
        f.launches = 0
