"""The legacy amp API: ``amp.init()`` handles and the deprecated
``OptimWrapper``.

Counterpart of ``apex_tpu/amp/legacy.py``: the reference Apex's original
handle-based surface (``handle = amp.init(enabled=...)``,
``handle.wrap_optimizer(opt)``, ``with handle.scale_loss(loss, opt):
...``) built on the modern pieces.  :class:`AmpHandle` installs the O1
``CastPolicy`` process-wide (``amp.policy.set_policy``) and its
``_deactivate`` restores ``NoPolicy``; :class:`NoOpHandle` passes
everything through.  :class:`OptimWrapper` drives an ``AmpOptimizer``
from ``amp.initialize`` (the port's stateful optimizer) with one loss
scaler a loss: each ``scale_loss`` of a step takes the next loss id, the
backward passes accumulate in the optimizer's grad stash, and ``step``
applies them.  Closures are refused, as in the reference.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

from . import policy as _policy
from ._process_optimizer import AmpOptimizer
from .handle import scale_loss as _scale_loss

__all__ = ["init", "AmpHandle", "NoOpHandle", "OptimWrapper"]


class AmpHandle:
    """Handle returned by the legacy ``amp.init(enabled=True)``."""

    def __init__(self, enable_caching: bool = True, verbose: bool = False,
                 half_dtype: torch.dtype = torch.bfloat16):
        # accepted for API parity: a cast is made where an op needs it,
        # so no cache object exists
        self._enable_caching = enable_caching
        self._verbose = verbose
        self._all_wrappers = []
        self._is_active = True
        _policy.set_policy(_policy.CastPolicy(half_dtype))

    def is_active(self) -> bool:
        return self._is_active

    def wrap_optimizer(self, optimizer, num_loss: int = 1):
        """The deprecated :class:`OptimWrapper` around ``optimizer``."""
        self._all_wrappers.append(optimizer)
        return OptimWrapper(optimizer, self, num_loss)

    @contextlib.contextmanager
    def scale_loss(self, loss: torch.Tensor, optimizer):
        """The legacy two-argument ``scale_loss``: ``optimizer`` is an
        :class:`OptimWrapper` or an optimizer ``amp.initialize``
        returned."""
        if isinstance(optimizer, OptimWrapper):
            with optimizer.scale_loss(loss) as scaled:
                yield scaled
            return
        with _scale_loss(loss, optimizer) as scaled:
            yield scaled

    def _deactivate(self) -> None:
        self._is_active = False
        _policy.set_policy(_policy.NoPolicy())


class NoOpHandle:
    """Handle returned by ``amp.init(enabled=False)``: everything passes
    through untouched."""

    def is_active(self) -> bool:
        return False

    def wrap_optimizer(self, optimizer, num_loss: int = 1):
        return OptimWrapper(optimizer, self, num_loss)

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer):
        yield loss

    def _deactivate(self) -> None:
        pass


def init(enabled: bool = True, enable_caching: bool = True,
         verbose: bool = False, allow_banned: bool = False,
         half_dtype: torch.dtype = torch.bfloat16):
    """The original amp entry point.  Prefer ``amp.initialize``."""
    if not enabled:
        return NoOpHandle()
    return AmpHandle(enable_caching, verbose, half_dtype)


class OptimWrapper:
    """Deprecated per-optimizer wrapper with a loss scaler a loss."""

    def __init__(self, optimizer, amp_handle, num_loss: int = 1):
        warnings.warn("OptimWrapper is deprecated; use amp.initialize + "
                      "amp.scaled_grad (or amp.scale_loss)",
                      DeprecationWarning, stacklevel=2)
        if not isinstance(optimizer, AmpOptimizer):
            raise TypeError("OptimWrapper drives the optimizer "
                            "amp.initialize returned, got "
                            f"{type(optimizer).__name__}")
        self._optimizer = optimizer
        self._amp_handle = amp_handle
        self._num_loss = num_loss
        self._loss_idx = 0
        if optimizer.masters is not None:
            self._add_scalers()

    def _add_scalers(self) -> None:
        """One loss scaler a loss in the bound optimizer."""
        opt = self._optimizer
        while len(opt.scalers) < self._num_loss:
            opt.scalers.append(opt.scaler.init_state(opt.masters.buf.device))
        opt.num_losses = len(opt.scalers)

    def setup(self, model: torch.nn.Module) -> None:
        """Bind an optimizer that is not bound yet to ``model`` (one from
        ``amp.initialize`` already is)."""
        opt = self._optimizer
        if opt.masters is None:
            opt.num_losses = max(opt.num_losses, self._num_loss)
            opt.bind(model)
        self._add_scalers()

    @property
    def params(self):
        return list(self._optimizer._params) or None

    @contextlib.contextmanager
    def scale_loss(self, loss: torch.Tensor):
        if self._optimizer.masters is None:
            raise RuntimeError("the optimizer is not bound to a model: call "
                               "OptimWrapper.setup(model) first")
        if self._loss_idx >= self._num_loss:
            raise RuntimeError(
                f"Unable to scale {self._num_loss + 1} losses: OptimWrapper "
                f"was constructed with num_loss={self._num_loss}")
        with _scale_loss(loss, self._optimizer,
                         loss_id=self._loss_idx) as scaled:
            yield scaled
        self._loss_idx += 1

    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError(
                "OptimWrapper does not support closures")
        self._loss_idx = 0
        self._optimizer.step()

    def zero_grad(self) -> None:
        self._optimizer.zero_grad()

    @property
    def loss_scale(self) -> float:
        return float(self._optimizer.scalers[0].loss_scale)

    def state_dict(self) -> dict:
        return {"scalers": self._optimizer.scalers_state_dict()}

    def __getattr__(self, name):
        return getattr(self._optimizer, name)
