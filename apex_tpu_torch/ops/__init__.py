"""Hand-written Hopper kernels and their wrappers.

``multi_tensor`` (scale, axpby, l2norm, global and per tensor), ``adam``,
``lamb`` (stage 1 and stage 2), ``syncbn`` (the BatchNorm apply, forward
and backward), ``layer_norm`` (forward and backward) and
``flash_attention`` (forward, dQ, dK/dV) wrap the CUDA C++
sources of ``csrc/``, which ``_build`` compiles with ``nvcc`` for sm_90a
at first launch and loads with ``ctypes``.  Importing this package
builds nothing.
"""

from __future__ import annotations

from typing import Dict

from . import (_launches, adam, flash_attention, lamb, layer_norm,
               multi_tensor, syncbn)
from .adam import fused_adam
from .flash_attention import flash_dkv, flash_dq, flash_fwd
from .lamb import lamb_stage1, lamb_stage2
from .layer_norm import layer_norm_bwd, layer_norm_fwd
from .multi_tensor import (ChunkTable, multi_tensor_axpby,
                           multi_tensor_l2norm,
                           multi_tensor_l2norm_per_tensor,
                           multi_tensor_scale)
from .syncbn import batch_norm_apply_fused, syncbn_bwd, syncbn_fwd

__all__ = ["fused_adam", "multi_tensor_scale", "multi_tensor_axpby",
           "multi_tensor_l2norm", "multi_tensor_l2norm_per_tensor",
           "ChunkTable", "lamb_stage1", "lamb_stage2", "syncbn_fwd",
           "syncbn_bwd",
           "batch_norm_apply_fused", "layer_norm_fwd", "layer_norm_bwd",
           "flash_fwd", "flash_dq", "flash_dkv", "WRAPPERS", "launch_counts",
           "reset_launch_counts", "add_launches"]

# every kernel wrapper of the port, by name
WRAPPERS = {f.__name__: f for f in (multi_tensor_scale, multi_tensor_axpby,
                                    multi_tensor_l2norm,
                                    multi_tensor_l2norm_per_tensor,
                                    fused_adam, lamb_stage1, lamb_stage2,
                                    syncbn_fwd, syncbn_bwd, layer_norm_fwd,
                                    layer_norm_bwd, flash_fwd, flash_dq,
                                    flash_dkv)}


def launch_counts() -> Dict[str, int]:
    """How many times each wrapper has launched its kernel.  A wrapper
    counts on the host when it launches; a step captured in a CUDA graph
    (``parallel.make_step``) takes its capture's launches back and adds
    them again at each replay, so the counts are those of the kernels
    that ran.  Every update takes ``_launches.LOCK``, so counts from
    several threads (a fleet's step pool) are exact."""
    with _launches.LOCK:
        return {name: f.launches for name, f in WRAPPERS.items()}


def reset_launch_counts() -> None:
    with _launches.LOCK:
        for f in WRAPPERS.values():
            f.launches = 0


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (wrapper name -> launches) to the
    counts: what a graph replay of recorded launches does."""
    with _launches.LOCK:
        for name, n in counts.items():
            WRAPPERS[name].launches += times * n
