"""FusedAdam: Adam over one flat fp32 parameter buffer.

Counterpart of ``apex_tpu/optimizers/fused_adam.py`` with the math of its
Pallas kernel (``ops/pallas_adam.py``): the grads are multiplied by the
reciprocal of the combined scale, and the bias correction is folded into
``step_size``, computed in fp32 tensors::

    m  = b1*m + (1-b1)*g~          g~ = g * (1/combined_scale)
    v  = b2*v + (1-b2)*g~*g~
    denom = sqrt(v + eps) | sqrt(v) + eps
    step_size = lr * sqrt(1-b2^t) / (1-b1^t)
    p -= step_size * (m/denom + weight_decay*p)

The step counter lives on the device and advances only on a step that was
not skipped, as the JAX package's skip branch leaves the state unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import ops
from .base import Optimizer, resolve_lr

__all__ = ["FusedAdam", "AdamState"]


@dataclass
class AdamState:
    step: torch.Tensor   # int32 0-d: number of applied updates
    m: torch.Tensor      # fp32 flat first moment
    v: torch.Tensor      # fp32 flat second moment


class FusedAdam(Optimizer):
    """Signature of the reference Apex FusedAdam, without ``params``:
    ``amp.initialize`` binds it to the model."""

    elementwise = True

    def __init__(self, lr=1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 eps_inside_sqrt: bool = False, weight_decay: float = 0.0,
                 max_grad_norm: float = 0.0, amsgrad: bool = False):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.eps_inside_sqrt = eps_inside_sqrt
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, flat_params: torch.Tensor) -> AdamState:
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=flat_params.device),
            m=torch.zeros_like(flat_params, dtype=torch.float32),
            v=torch.zeros_like(flat_params, dtype=torch.float32))

    def step(self, flat_params: torch.Tensor, state: AdamState,
             flat_grads: torch.Tensor, scale=1.0,
             grad_norm: Optional[torch.Tensor] = None,
             half: Optional[torch.Tensor] = None,
             noop: Optional[torch.Tensor] = None) -> None:
        """One Adam step, in place on ``flat_params``, ``state`` and
        ``half`` (the half copy of the new params, when given).

        ``scale``: the grads are divided by it (as a multiply by its
        reciprocal).  ``grad_norm``: the global norm of the scaled grads
        for clipping, computed by the l2norm kernel when ``max_grad_norm``
        is set and none is given.  ``noop``: a found-inf flag; when it is
        non-zero nothing changes, the step counter included."""
        combined = ops.multi_tensor.as_scalar(scale, flat_params)
        if self.max_grad_norm > 0:
            if grad_norm is None:
                grad_norm = ops.multi_tensor_l2norm(flat_grads)
            clip = ((grad_norm / combined) + 1e-6) / self.max_grad_norm
            combined = torch.where(clip > 1.0, clip * combined, combined)
        inv_scale = 1.0 / combined

        t = state.step + 1
        beta1, beta2 = self.betas
        lr = resolve_lr(self.lr, state.step)
        if self.bias_correction:
            tf = t.to(torch.float32)
            bc1 = 1.0 - torch.pow(beta1, tf)
            bc2 = 1.0 - torch.pow(beta2, tf)
            step_size = lr * torch.sqrt(bc2) / bc1
        else:
            step_size = ops.multi_tensor.as_scalar(lr, flat_params)

        ops.fused_adam(flat_params, state.m, state.v, flat_grads, step_size,
                       inv_scale, beta1, beta2, self.eps,
                       self.eps_inside_sqrt, self.weight_decay, half=half,
                       noop=noop)
        if noop is None:
            state.step.add_(1)
        else:
            state.step.add_((noop == 0).to(torch.int32))
