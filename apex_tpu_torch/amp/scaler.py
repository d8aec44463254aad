"""Loss scaling, static and dynamic, on 0-d device tensors.

Counterpart of ``apex_tpu/amp/scaler.py``, with the same transitions:
the dynamic scale starts at 2**16, halves on overflow (clamped at
``min_loss_scale``), doubles after ``scale_window`` clean steps (clamped
at ``max_loss_scale``).  The state is three 0-d tensors on the model's
device and every transition is tensor arithmetic, so a training step
brings nothing back to the host.  Python constants enter as scalars of
the ops (no host-to-device copies).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import torch

from .. import ops
from ..ops.multi_tensor import as_scalar

__all__ = ["ScalerState", "LossScaler"]


@dataclass
class ScalerState:
    loss_scale: torch.Tensor     # fp32 0-d
    unskipped: torch.Tensor      # int32 0-d: clean steps since the last change
    steps_skipped: torch.Tensor  # int32 0-d: total skipped


class LossScaler:
    """Configuration plus pure transition functions over ScalerState."""

    def __init__(self, loss_scale: Any = "dynamic",
                 init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 2000,
                 min_loss_scale: Optional[float] = None,
                 max_loss_scale: float = 2.0 ** 24):
        if loss_scale == "dynamic":
            self.dynamic = True
            self._init_scale = init_scale
        else:
            self.dynamic = False
            self._init_scale = float(loss_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_loss_scale = min_loss_scale
        self.max_loss_scale = max_loss_scale

    def init_state(self, device) -> ScalerState:
        z = torch.zeros((), dtype=torch.int32, device=device)
        return ScalerState(
            loss_scale=torch.full((), self._init_scale, dtype=torch.float32,
                                  device=device),
            unskipped=z, steps_skipped=z.clone())

    def scale_loss(self, loss: torch.Tensor, state: ScalerState
                   ) -> torch.Tensor:
        return loss.float() * state.loss_scale

    def unscale(self, flat_grads: torch.Tensor, state: ScalerState,
                out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """grads / scale with the fused overflow check (the scale kernel
        with the reciprocal, as the JAX package passes it)."""
        return ops.multi_tensor_scale(flat_grads, 1.0 / state.loss_scale,
                                      out=out)

    def unscale_with_stashed(self, flat_grads: torch.Tensor,
                             stashed: torch.Tensor, state: ScalerState,
                             out: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``grads/scale + stashed``: accumulation across backward passes
        (axpby, finite check on the new grads)."""
        inv = 1.0 / state.loss_scale
        return ops.multi_tensor_axpby(inv, as_scalar(1.0, inv), flat_grads,
                                      stashed, arg_to_check=0, out=out)

    def update(self, state: ScalerState, found_inf: torch.Tensor
               ) -> ScalerState:
        """The transition of apex_tpu's ``LossScaler.update``."""
        overflow = found_inf > 0
        skipped = state.steps_skipped + overflow.to(torch.int32)
        if not self.dynamic:
            return replace(state, steps_skipped=skipped)
        halved = state.loss_scale / self.scale_factor
        if self.min_loss_scale is not None:
            halved = torch.clamp_min(halved, self.min_loss_scale)
        zero = torch.zeros_like(state.unskipped)
        unskipped = torch.where(overflow, zero, state.unskipped + 1)
        grow = unskipped >= self.scale_window
        grown = torch.clamp_max(state.loss_scale * self.scale_factor,
                                self.max_loss_scale)
        new_scale = torch.where(overflow, halved,
                                torch.where(grow, grown, state.loss_scale))
        unskipped = torch.where(grow, zero, unskipped)
        return ScalerState(loss_scale=new_scale, unskipped=unskipped,
                           steps_skipped=skipped)

    def update_(self, state: ScalerState, found_inf: torch.Tensor) -> None:
        """:meth:`update`, written in place into ``state``'s tensors."""
        new = self.update(state, found_inf)
        state.loss_scale.copy_(new.loss_scale)
        state.unskipped.copy_(new.unskipped)
        state.steps_skipped.copy_(new.steps_skipped)
