"""Utilities: named ranges and profiler windows (``profiler``), checkpoints
in the JAX package's file format (``checkpoint``), ``jax_interop``
(weights and optimizer state to and from the JAX package) and ``ema``
(parameter averaging)."""

from .profiler import (range_push, range_pop, nvtx_range, annotate,
                       start_profile, stop_profile, profile,
                       profiling_active, current_capture_dir,
                       last_capture_dir, AverageMeter)
from .checkpoint import (save_checkpoint, restore_checkpoint, latest_step,
                         available_steps)
from . import ema

__all__ = ["ema", "range_push", "range_pop", "nvtx_range", "annotate",
           "start_profile", "stop_profile", "profile", "profiling_active",
           "current_capture_dir", "last_capture_dir",
           "AverageMeter", "save_checkpoint", "restore_checkpoint",
           "latest_step", "available_steps"]
