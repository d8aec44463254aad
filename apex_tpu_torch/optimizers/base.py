"""Optimizer protocol for the port.

Counterpart of ``apex_tpu/optimizers/base.py``.  An optimizer holds
hyperparameters; ``init(flat_params)`` makes its state for a flat fp32
buffer, and ``step(flat_params, state, flat_grads, half=, noop=)``
updates both in place (the JAX package returns new arrays; the port
updates in place to save the memory of a second copy), writes the half
copy of the new params into ``half`` when given, and changes nothing when
the found-inf flag ``noop`` is set.  ``amp.initialize`` binds it to a
model through an ``AmpOptimizer``.
"""

from __future__ import annotations

from typing import Any, Callable, Union

import torch

__all__ = ["Optimizer", "resolve_lr"]

Schedule = Union[float, Callable[[torch.Tensor], Any]]


def resolve_lr(lr: Schedule, step: torch.Tensor) -> Union[float, torch.Tensor]:
    """The learning rate at ``step`` (the count of applied updates): a
    Python float as it is (it enters the step-size arithmetic as an fp32
    scalar, with no host-to-device copy), or a schedule's value as an fp32
    tensor on ``step``'s device."""
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=torch.float32,
                               device=step.device)
    return float(lr)


class Optimizer:
    def init(self, flat_params: torch.Tensor) -> Any:
        raise NotImplementedError

    def step(self, flat_params: torch.Tensor, state: Any,
             flat_grads: torch.Tensor, **kwargs) -> None:
        raise NotImplementedError
