"""Optimizers of the port: FusedAdam and FusedLAMB (on the CUDA kernels),
SGD and FusedLion (plain tensor ops, as the JAX package's are jnp), and
FP16_Optimizer."""

from .base import SGD, Optimizer, SGDState, resolve_lr
from .fp16_optimizer import FP16_Optimizer, FP16OptState
from .fused_adam import AdamState, FusedAdam
from .fused_lamb import FusedLAMB, LambState
from .fused_lion import FusedLion, LionState

__all__ = ["Optimizer", "resolve_lr", "SGD", "SGDState", "FusedAdam",
           "AdamState", "FusedLAMB", "LambState", "FusedLion", "LionState",
           "FP16_Optimizer", "FP16OptState"]
