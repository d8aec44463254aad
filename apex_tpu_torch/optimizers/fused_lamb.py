"""FusedLAMB: layer-wise adaptive large-batch optimizer over one flat fp32
buffer.

Counterpart of ``apex_tpu/optimizers/fused_lamb.py`` with the math of its
Pallas kernels (``ops/pallas_lamb.py``: the grads are multiplied by
``1/clip``, the moments by ``1/(1 - beta^t)``, where the jnp path divides).
One step, all on the device (no host sync)::

    grad_norm = sqrt(sum of the per-tensor sums of g^2)
    clip      = grad_norm / max_grad_norm if grad_norm > max_grad_norm, else 1
    stage 1   m, v and u = m^ / (sqrt(v^) + eps) (+ wd*p)     (ops.lamb_stage1)
    ratio     = ||p|| / ||u|| per tensor, 1 where either is 0
    stage 2   p -= lr * ratio * u, and the half copy          (ops.lamb_stage2)

with the per-tensor sums of g^2, p^2 and u^2 from the per-tensor l2norm
kernel over the layout's chunk table.  The optimizer is not elementwise:
``init(flat_params, layout)`` takes the buffer's ``ChunkedFlatLayout``,
which the state keeps (the JAX package's ``ChunkedFlat`` moments).  The
step counter advances only on a step that was not skipped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import ops
from ..multi_tensor_apply.flatten import ChunkedFlat, ChunkedFlatLayout
from .base import Optimizer, resolve_lr

__all__ = ["FusedLAMB", "LambState"]


@dataclass
class LambState:
    step: torch.Tensor   # int32 0-d: number of applied updates
    m: ChunkedFlat       # fp32 moments over the flat buffer, with its layout
    v: ChunkedFlat


class FusedLAMB(Optimizer):
    """The JAX package's FusedLAMB, without ``params``: ``amp.initialize``
    binds it to the model.  ``use_nvlamb`` is accepted and, as there, has
    no effect: the trust ratio applies to every tensor."""
    elementwise = False

    def __init__(self, lr=1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, amsgrad: bool = False,
                 adam_w_mode: bool = True, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb

    def init(self, flat_params: torch.Tensor,
             layout: ChunkedFlatLayout) -> LambState:
        if layout.total != flat_params.numel():
            raise ValueError(f"layout of {layout.total} elements for a "
                             f"buffer of {flat_params.numel()}")
        zeros = torch.zeros_like(flat_params, dtype=torch.float32)
        return LambState(
            step=torch.zeros((), dtype=torch.int32, device=flat_params.device),
            m=ChunkedFlat(zeros, layout), v=ChunkedFlat(zeros.clone(), layout))

    def step(self, flat_params: torch.Tensor, state: LambState,
             flat_grads: torch.Tensor,
             grad_norm: Optional[torch.Tensor] = None,
             half: Optional[torch.Tensor] = None,
             noop: Optional[torch.Tensor] = None) -> None:
        """One LAMB step, in place on ``flat_params``, ``state`` and
        ``half`` (the half copy of the new params, when given).
        ``grad_norm``: the global norm of the grads for clipping, from
        their per-tensor sums when none is given.  ``noop``: a found-inf
        flag; when it is non-zero nothing changes, the step counter
        included."""
        lay = state.m.layout
        table = lay.chunk_table(flat_params.device)
        beta1, beta2 = self.betas
        beta3 = 1.0 - beta1 if self.grad_averaging else 1.0
        lr = resolve_lr(self.lr, state.step)
        one = torch.ones((), dtype=torch.float32, device=flat_params.device)

        if grad_norm is None:
            grad_norm = torch.sqrt(torch.sum(
                ops.multi_tensor_l2norm_per_tensor(flat_grads, table)))
        if self.max_grad_norm and self.max_grad_norm > 0:
            clip = torch.where(grad_norm > self.max_grad_norm,
                               grad_norm / self.max_grad_norm, one)
        else:
            clip = one
        if self.bias_correction:
            tf = (state.step + 1).to(torch.float32)
            bc1 = 1.0 - torch.pow(beta1, tf)
            bc2 = 1.0 - torch.pow(beta2, tf)
        else:
            bc1 = bc2 = one

        upd = ops.lamb_stage1(flat_grads, flat_params, state.m.buf,
                              state.v.buf, 1.0 / clip, 1.0 / bc1, 1.0 / bc2,
                              beta1, beta2, beta3, self.eps,
                              self.weight_decay, self.adam_w_mode, noop=noop)
        p_sq = ops.multi_tensor_l2norm_per_tensor(flat_params, table)
        u_sq = ops.multi_tensor_l2norm_per_tensor(upd, table)
        ratio = torch.where((p_sq > 0) & (u_sq > 0),
                            torch.sqrt(p_sq) / torch.sqrt(u_sq), one)
        ops.lamb_stage2(flat_params, upd, ratio, table, lr, half=half,
                        noop=noop)
        state.step.add_(1 if noop is None else (noop == 0).to(torch.int32))
