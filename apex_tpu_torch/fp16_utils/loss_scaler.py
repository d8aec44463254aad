"""The legacy ``LossScaler`` and ``DynamicLossScaler``.

Counterpart of ``apex_tpu/fp16_utils/loss_scaler.py``: host-side Python
state with the reference's attribute surface (``cur_scale``, ``cur_iter``,
``last_overflow_iter``, ``scale_factor``, ``scale_window``) for scripts
written against the legacy API; new code uses ``amp.LossScaler``'s device
state.  The dynamic scale halves on overflow (never below 1.0) and doubles
every ``scale_window`` iterations counted from the last overflow.
``has_overflow`` is one fused inf/nan check over the grads and one read
of its flag on the host: the legacy path is eager.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

__all__ = ["LossScaler", "DynamicLossScaler"]

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _as_list(grads: Tensors):
    return [grads] if isinstance(grads, torch.Tensor) else list(grads)


class LossScaler:
    """Static scaler."""

    def __init__(self, scale: float = 1.0):
        self.cur_scale = float(scale)

    @property
    def loss_scale(self) -> float:
        return self.cur_scale

    def has_overflow(self, grads: Tensors) -> bool:
        return False

    def update_scale(self, overflow: bool) -> None:
        pass

    def scale_gradient(self, grads: Tensors):
        """Each grad times the loss scale (new tensors)."""
        return [g * self.loss_scale for g in _as_list(grads)]

    def backward(self, loss: torch.Tensor) -> None:
        """Backward of ``loss * loss_scale``: the scaled grads land in the
        parameters' ``.grad``."""
        (loss.float() * self.loss_scale).backward()


class DynamicLossScaler(LossScaler):
    """Halve on overflow, double every ``scale_window`` clean
    iterations."""

    def __init__(self, init_scale: float = 2 ** 32, scale_factor: float = 2.,
                 scale_window: int = 1000):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window

    def has_overflow(self, grads: Tensors) -> bool:
        grads = [g for g in _as_list(grads) if g is not None]
        if not grads:
            return False
        bad = torch.stack([(~torch.isfinite(g.float())).any()
                           for g in grads]).any()
        return bool(bad)

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1.0)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) \
                % self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1
