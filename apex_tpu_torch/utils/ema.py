"""Exponential moving average of parameters (Polyak averaging).

Counterpart of ``apex_tpu/utils/ema.py``, on lists of tensors::

    ema_state = ema.init(params)
    ema_state = ema.update(ema_state, params, decay=0.999)   # each step
    eval_params = ema.value(ema_state, decay=0.999)          # debiased

``value`` divides by ``1 - decay**step`` (Adam-style debias), so early
averages are not shrunk toward the zero start.  The average is fp32;
cast it to the model's dtype where needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

__all__ = ["EmaState", "init", "update", "value"]


@dataclass
class EmaState:
    avg: List[torch.Tensor]   # fp32, one per parameter
    step: torch.Tensor        # int32 0-d: number of updates applied


def init(params: Sequence[torch.Tensor]) -> EmaState:
    return EmaState(
        avg=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        step=torch.zeros((), dtype=torch.int32,
                         device=params[0].device if params else None))


def update(state: EmaState, params: Sequence[torch.Tensor],
           decay: float = 0.999) -> EmaState:
    with torch.no_grad():
        avg = [decay * a + (1.0 - decay) * p.to(torch.float32)
               for a, p in zip(state.avg, params)]
    return EmaState(avg=avg, step=state.step + 1)


def value(state: EmaState, decay: float = 0.999) -> List[torch.Tensor]:
    """The debiased average (fp32)."""
    corr = 1.0 - torch.pow(torch.full((), decay, dtype=torch.float32,
                                      device=state.step.device),
                           state.step.to(torch.float32))
    corr = torch.clamp_min(corr, 1e-12)
    return [a / corr for a in state.avg]
