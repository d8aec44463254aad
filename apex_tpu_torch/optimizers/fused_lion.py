"""FusedLion: Lion (Chen et al. 2023) over one flat fp32 parameter buffer.

Counterpart of ``apex_tpu/optimizers/fused_lion.py``.  The JAX package
computes it in jnp with no Pallas kernel (Lion is one elementwise pass),
so the port's is plain tensor ops on the flat buffer, with the JAX
package's arithmetic (a division by the combined scale)::

    g~ = g / combined_scale
    u  = sign(b1*m + (1-b1)*g~)
    p -= lr * (u + weight_decay*p)          (decoupled decay)
    m  = b2*m + (1-b2)*g~

One moment buffer, half of Adam's optimizer state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import ops
from ..ops.multi_tensor import as_scalar
from .base import Optimizer, apply_or_skip, resolve_lr

__all__ = ["FusedLion", "LionState"]


@dataclass
class LionState:
    step: torch.Tensor   # int32 0-d: number of applied updates
    m: torch.Tensor      # fp32 flat momentum


class FusedLion(Optimizer):
    elementwise = True

    def __init__(self, lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0):
        self.lr = lr
        self.betas = betas
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, flat_params: torch.Tensor) -> LionState:
        return LionState(
            step=torch.zeros((), dtype=torch.int32, device=flat_params.device),
            m=torch.zeros_like(flat_params, dtype=torch.float32))

    def step(self, flat_params: torch.Tensor, state: LionState,
             flat_grads: torch.Tensor, scale=1.0,
             grad_norm: Optional[torch.Tensor] = None,
             half: Optional[torch.Tensor] = None,
             noop: Optional[torch.Tensor] = None) -> None:
        """One Lion step in place (``scale``/``grad_norm`` as in
        ``FusedAdam.step``); the half copy into ``half`` when given."""
        combined = as_scalar(scale, flat_params)
        if self.max_grad_norm > 0:
            if grad_norm is None:
                grad_norm = ops.multi_tensor_l2norm(flat_grads)
            clip = ((grad_norm / combined) + 1e-6) / self.max_grad_norm
            combined = torch.where(clip > 1.0, clip * combined, combined)
        beta1, beta2 = self.betas
        lr = resolve_lr(self.lr, state.step)
        gs = flat_grads / combined
        update = torch.sign(beta1 * state.m + (1.0 - beta1) * gs)
        new_p = flat_params - lr * (update + self.weight_decay * flat_params)
        new_m = beta2 * state.m + (1.0 - beta2) * gs
        apply_or_skip(noop, [(flat_params, new_p), (state.m, new_m),
                             (half, None if half is None
                              else new_p.to(half.dtype))])
        state.step.add_(1 if noop is None else (noop == 0).to(torch.int32))
