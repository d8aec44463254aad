"""Optimizer protocol for the port, and SGD.

Counterpart of ``apex_tpu/optimizers/base.py``.  An optimizer holds
hyperparameters; ``step(flat_params, state, flat_grads, half=, noop=)``
updates the flat fp32 buffer and the state in place (the JAX package
returns new arrays; the port updates in place to save the memory of a
second copy), writes the half copy of the new params into ``half`` when
given, and changes nothing when the found-inf flag ``noop`` is set.
``amp.initialize`` binds it to a model through an ``AmpOptimizer``.

``elementwise`` says whether the update treats every element alike.  An
elementwise optimizer makes its state with ``init(flat_params)``; one
with per-tensor semantics (LAMB's and LARC's trust ratios) with
``init(flat_params, layout)``, ``layout`` the
``multi_tensor_apply.ChunkedFlatLayout`` of the buffer, which tells it
where each tensor lies.  (The JAX package keys on the same attribute: an
optimizer that is not elementwise gets the master tree there.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

import torch

__all__ = ["Optimizer", "resolve_lr", "SGD", "SGDState", "apply_or_skip"]

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
    elementwise = False

    def init(self, flat_params: torch.Tensor, *layout) -> Any:
        raise NotImplementedError

    def step(self, flat_params: torch.Tensor, state: Any,
             flat_grads: torch.Tensor, **kwargs) -> None:
        raise NotImplementedError


def apply_or_skip(noop: Optional[torch.Tensor], pairs) -> None:
    """Write each ``(buffer, new value)`` of ``pairs`` into its buffer,
    unless the found-inf flag ``noop`` is set (then nothing changes): the
    JAX package's skip branch, for optimizers in plain tensor ops.  A
    ``None`` buffer is skipped."""
    for buf, new in pairs:
        if buf is None:
            continue
        if noop is not None:
            new = torch.where(noop != 0, buf, new)
        buf.copy_(new)


@dataclass
class SGDState:
    step: torch.Tensor                # int32 0-d: number of applied updates
    momentum: Optional[torch.Tensor]  # fp32 flat, or None without momentum


class SGD(Optimizer):
    """SGD with momentum, dampening, Nesterov and L2 weight decay, on the
    flat buffer in plain tensor ops (the JAX package's is jnp too)."""
    elementwise = True

    def __init__(self, lr: Schedule = 0.01, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 dampening: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.dampening = dampening

    def init(self, flat_params: torch.Tensor) -> SGDState:
        return SGDState(
            step=torch.zeros((), dtype=torch.int32, device=flat_params.device),
            momentum=(torch.zeros_like(flat_params, dtype=torch.float32)
                      if self.momentum else None))

    def step(self, flat_params: torch.Tensor, state: SGDState,
             flat_grads: torch.Tensor, half: Optional[torch.Tensor] = None,
             noop: Optional[torch.Tensor] = None) -> None:
        lr = resolve_lr(self.lr, state.step)
        g = flat_grads
        if self.weight_decay:
            g = g + self.weight_decay * flat_params
        new_mom = None
        if state.momentum is not None:
            new_mom = self.momentum * state.momentum + (
                1.0 - self.dampening) * g
            g = g + self.momentum * new_mom if self.nesterov else new_mom
        new_p = flat_params - lr * g
        apply_or_skip(noop, [(flat_params, new_p),
                             (state.momentum, new_mom),
                             (half, None if half is None
                              else new_p.to(half.dtype))])
        state.step.add_(1 if noop is None else (noop == 0).to(torch.int32))
