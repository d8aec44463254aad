"""Optimizers of the port (``FusedAdam`` so far)."""

from .base import Optimizer, resolve_lr
from .fused_adam import AdamState, FusedAdam

__all__ = ["Optimizer", "resolve_lr", "FusedAdam", "AdamState"]
