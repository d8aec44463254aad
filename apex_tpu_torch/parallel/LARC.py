"""LARC: layer-wise adaptive rate control, as an optimizer wrapper.

Counterpart of ``apex_tpu/parallel/LARC.py`` (reference LARC.py:68-97):
each tensor's grads are rescaled before the wrapped optimizer runs, by

    adaptive_lr = trust_coefficient * ||p|| / (||g|| + wd*||p|| + eps)

(1 where either norm is 0); ``clip=True`` caps the effective rate at the
base lr, ``min(adaptive_lr / lr, 1)``.  The inner optimizer's weight decay
is folded into the grads, ``(g + wd*p) * adaptive_lr``, and zeroed on the
inner optimizer, as the reference does to its param groups.

LARC is not elementwise: ``init(flat_params, layout)`` takes the flat
buffer's ``ChunkedFlatLayout``, and the per-tensor norms come from the
per-tensor l2norm kernel over its chunk table.  It wraps the elementwise
optimizers (FusedAdam, SGD).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from .. import ops
from ..multi_tensor_apply.flatten import ChunkedFlatLayout
from ..optimizers.base import Optimizer, resolve_lr

__all__ = ["LARC", "LarcState"]


@dataclass
class LarcState:
    inner: Any                  # the wrapped optimizer's state
    layout: ChunkedFlatLayout

    @property
    def step(self) -> torch.Tensor:
        return self.inner.step


class LARC(Optimizer):
    elementwise = False

    def __init__(self, optimizer: Optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8):
        if not optimizer.elementwise:
            raise TypeError("LARC wraps an elementwise optimizer (FusedAdam, "
                            "SGD)")
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = float(getattr(optimizer, "weight_decay", 0.0))
        if self.weight_decay:
            optimizer.weight_decay = 0.0

    def init(self, flat_params: torch.Tensor,
             layout: ChunkedFlatLayout) -> LarcState:
        return LarcState(self.optim.init(flat_params), layout)

    def step(self, flat_params: torch.Tensor, state: LarcState,
             flat_grads: torch.Tensor, half: Optional[torch.Tensor] = None,
             noop: Optional[torch.Tensor] = None) -> None:
        lay = state.layout
        table = lay.chunk_table(flat_params.device)
        lr = resolve_lr(self.optim.lr, state.step)
        wd = self.weight_decay
        p_norm = torch.sqrt(ops.multi_tensor_l2norm_per_tensor(flat_params,
                                                               table))
        g_norm = torch.sqrt(ops.multi_tensor_l2norm_per_tensor(flat_grads,
                                                               table))
        adaptive = self.trust_coefficient * p_norm / (
            g_norm + wd * p_norm + self.eps)
        adaptive = torch.where((p_norm > 0) & (g_norm > 0), adaptive,
                               torch.ones_like(adaptive))
        if self.clip:
            adaptive = torch.clamp_max(adaptive / lr, 1.0)
        grads = (flat_grads + wd * flat_params) * lay.expand_per_tensor(
            adaptive)
        self.optim.step(flat_params, state.inner, grads, half=half,
                        noop=noop)
