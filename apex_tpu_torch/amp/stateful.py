"""Gradient accumulation across backward passes within one step.

Counterpart of the grad stash of ``apex_tpu/amp/stateful.py``
(``BoundOptimizer._backward``/``_post_backward``).  After each backward
that ``amp.scale_loss`` drives, the model's grads are packed into one
flat fp32 buffer in the optimizer's layout and unscaled: the first
backward of a step through the scale kernel, every later one through
axpby (``grads/scale + stashed``), as ``LossScaler.unscale_with_stashed``
does.  The found-inf flags of all of them are OR-ed.  As in apex_tpu,
``delay_unscale`` only postpones the loss scaler's update; the grads are
unscaled and stashed all the same.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..multi_tensor_apply import pack_flat
from .scaler import LossScaler, ScalerState

__all__ = ["GradStash"]


class GradStash:
    """Two persistent flat fp32 buffers: ``grads``, the unscaled grads
    summed over this step's backward passes, and ``packed``, where a later
    backward's scaled grads land before axpby folds them in."""

    def __init__(self, total: int, device: torch.device):
        self.grads = torch.empty(total, dtype=torch.float32, device=device)
        self.packed = torch.empty(total, dtype=torch.float32, device=device)
        self.found_inf = torch.zeros((), dtype=torch.float32, device=device)
        self.has_grads = False

    def clear(self) -> None:
        self.has_grads = False
        self.found_inf.zero_()

    def add(self, params: Sequence[torch.nn.Parameter], scaler: LossScaler,
            sstate: ScalerState) -> None:
        """Unscale this backward's grads (``p.grad``, in layout order;
        a param without a grad contributes zeros) into the stash."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if not self.has_grads:
            pack_flat(grads, out=self.grads)
            # in place: the packed scaled grads are not needed afterwards
            _, found = scaler.unscale(self.grads, sstate, out=self.grads)
            self.has_grads = True
        else:
            pack_flat(grads, out=self.packed)
            _, found = scaler.unscale_with_stashed(self.packed, self.grads,
                                                   sstate, out=self.grads)
        torch.maximum(self.found_inf, found, out=self.found_inf)
