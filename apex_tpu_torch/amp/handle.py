"""``amp.scale_loss``: the reference Apex's context manager.

Counterpart of ``apex_tpu/amp/handle.py``.  PyTorch has a tape, so
``loss`` is a tensor (the JAX package takes a callable).  On entry the
model's grads are cleared and the loss is scaled; on exit this backward's
grads are unscaled into the optimizer's flat stash (the scale kernel,
then axpby for every later backward of the step) and, unless
``delay_unscale``, the loss scaler is updated.  An overflowed step is
skipped on the device by the next ``optimizer.step()``.
"""

from __future__ import annotations

import contextlib

import torch

from ._process_optimizer import AmpOptimizer

__all__ = ["scale_loss"]


@contextlib.contextmanager
def scale_loss(loss: torch.Tensor, optimizer: AmpOptimizer, loss_id: int = 0,
               model=None, delay_unscale: bool = False,
               delay_overflow_check: bool = False):
    if isinstance(optimizer, (list, tuple)):
        raise NotImplementedError(
            "pass a single optimizer per scale_loss context")
    if not isinstance(optimizer, AmpOptimizer):
        raise TypeError("scale_loss needs the optimizer amp.initialize "
                        f"returned, got {type(optimizer).__name__}")
    if not isinstance(loss, torch.Tensor):
        raise TypeError(f"loss must be a tensor, got {type(loss).__name__}")
    optimizer._prepare_backward()
    yield optimizer.scaler.scale_loss(loss, optimizer.scalers[loss_id])
    optimizer._post_backward(loss_id,
                             delay_unscale or delay_overflow_check)
