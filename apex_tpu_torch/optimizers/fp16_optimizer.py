"""FP16_Optimizer (fused flavour): fp32 master weights for FusedAdam over
half-precision model parameters.

Counterpart of ``apex_tpu/optimizers/fp16_optimizer.py``: the masters are
one flat fp32 buffer beside the model's half parameters; a step takes the
global norm of the incoming scaled grads (-1 when it is not finite, the
reference's overflow signal), skips the update on overflow and moves the
loss scale (the amp ``LossScaler``'s transitions), and otherwise hands the
flat grads to FusedAdam with the loss scale as its combined scale.  Then
the masters are copied back into the half parameters.  Everything stays
on the device: a skip is FusedAdam's no-op flag.  ``state_dict`` /
``load_state_dict`` checkpoint the state with the JAX package's keys
(``masters``, ``adam``, ``scaler``): the masters saved apart from the
model's weights, the reference's "option 2".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from ..amp.scaler import LossScaler, ScalerState
from ..multi_tensor_apply import global_grad_norm, pack_flat, unpack_flat
from .fused_adam import AdamState, FusedAdam

__all__ = ["FP16_Optimizer", "FP16OptState"]


@dataclass
class FP16OptState:
    masters: torch.Tensor    # fp32 flat master weights
    adam: AdamState
    scaler: ScalerState


class FP16_Optimizer:
    def __init__(self, init_optimizer: FusedAdam,
                 static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = True):
        if not isinstance(init_optimizer, FusedAdam):
            raise TypeError("FP16_Optimizer is designed only for FusedAdam "
                            "(like the reference, fp16_optimizer.py:28)")
        self.optimizer = init_optimizer
        if dynamic_loss_scale:
            self.loss_scaler = LossScaler("dynamic",
                                          **(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)
        self.verbose = verbose

    def init(self, params: Sequence[torch.Tensor]) -> FP16OptState:
        masters = pack_flat([p.detach() for p in params], torch.float32)
        return FP16OptState(masters=masters,
                            adam=self.optimizer.init(masters),
                            scaler=self.loss_scaler.init_state(
                                masters.device))

    def loss_scale(self, state: FP16OptState) -> torch.Tensor:
        return state.scaler.loss_scale

    def scale_loss(self, loss: torch.Tensor,
                   state: FP16OptState) -> torch.Tensor:
        return self.loss_scaler.scale_loss(loss, state.scaler)

    def backward(self, loss: torch.Tensor, state: FP16OptState) -> None:
        """Backward of the scaled loss (reference fp16_optimizer.py:
        163-172); the scaled grads land in the parameters' ``.grad``."""
        self.scale_loss(loss, state).backward()

    def step(self, params: Sequence[torch.Tensor], state: FP16OptState,
             scaled_grads: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Overflow check by the grad norm, then the update or the skip,
        in place on ``state`` and ``params``."""
        norm = global_grad_norm(list(scaled_grads))   # -1 on inf/nan
        found_inf = (norm < 0).to(torch.float32)
        self.optimizer.step(state.masters, state.adam,
                            pack_flat(list(scaled_grads), torch.float32),
                            scale=state.scaler.loss_scale,
                            grad_norm=torch.clamp_min(norm, 0.0),
                            noop=found_inf)
        with torch.no_grad():
            for p, m in zip(params, unpack_flat(state.masters, params)):
                p.copy_(m)
        state.scaler = self.loss_scaler.update(state.scaler, found_inf)
        return {"found_inf": found_inf, "grad_norm": norm,
                "loss_scale": state.scaler.loss_scale}

    # -- checkpointing (reference fp16_optimizer.py:211-274) ------------------
    def state_dict(self, state: FP16OptState) -> dict:
        """References to ``state``'s tensors, by the JAX package's keys."""
        return {"masters": state.masters, "adam": dict(vars(state.adam)),
                "scaler": dict(vars(state.scaler))}

    def load_state_dict(self, sd: dict) -> FP16OptState:
        """A new state from what :meth:`state_dict` gave (copies)."""
        def t(v):
            return torch.as_tensor(v).clone()
        return FP16OptState(
            masters=t(sd["masters"]),
            adam=AdamState(**{k: t(v) for k, v in sd["adam"].items()}),
            scaler=ScalerState(**{k: t(v) for k, v in sd["scaler"].items()}))
