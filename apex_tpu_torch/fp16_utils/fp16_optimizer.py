"""The legacy FP16_Optimizer: fp32 master weights around any port optimizer.

Counterpart of ``apex_tpu/fp16_utils/fp16_optimizer.py`` (the JAX
package's eager flavour for legacy scripts; the fused flavour is
``optimizers.FP16_Optimizer``).  It wraps any port optimizer, whose
protocol is flat (``step(flat, state, flat_grads, half=, noop=)``), owns
loss scaling and keeps the reference's four calls::

    opt = FP16_Optimizer(FusedAdam(lr=5e-4), dynamic_loss_scale=True)
    opt.setup(model)                # or a list of its parameters
    opt.backward(loss)              # scaled; grads accumulate across calls
    opt.clip_master_grads(1.0)      # optional
    opt.step()                      # skipped on overflow

``setup`` lays the parameters out in one flat fp32 master buffer and, for
the half parameters, one flat buffer of their dtype that the parameters
then view (fp32 parameters view the masters), so the inner optimizer's
step writes the model copy in its own pass (Adam's kernel writes the half
output beside the masters).  ``backward`` runs the scaled loss's backward
into the parameters' ``.grad``, which accumulate as torch's do;
``update_master_grads`` packs them into one fp32 buffer and unscales it
through the scale kernel with its fused found-inf flag, read once on the
host (the legacy path is eager); ``step`` moves the loss scale (the amp
``LossScaler``'s transitions on device tensors) and skips on overflow, or
retries a closure until a step applies.  ``state_dict`` holds the JAX
package's keys: ``loss_scaler``, ``overflow``,
``first_closure_call_this_step``, ``optimizer_state`` and
``fp32_from_fp16`` (the masters, apart from the model's weights).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ..amp._amp_state import maybe_print
from ..amp._process_optimizer import _load_state, _state_to_dict
from ..amp.scaler import LossScaler as _FunctionalScaler, ScalerState
from ..multi_tensor_apply import ChunkedFlatLayout, pack_flat
from .fp16util import _param_list, clip_grad_norm

__all__ = ["FP16_Optimizer"]


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = True):
        self.optimizer = init_optimizer
        if dynamic_loss_scale:
            self.loss_scaler = _FunctionalScaler(
                "dynamic", **(dynamic_loss_args or {}))
        else:
            self.loss_scaler = _FunctionalScaler(static_loss_scale)
        self.verbose = verbose
        self.overflow = False
        self.first_closure_call_this_step = True
        self._params: Optional[List[torch.Tensor]] = None
        self.masters: Optional[torch.Tensor] = None
        self._half: Optional[torch.Tensor] = None
        self._copies: List = []
        self._inner_state = None
        self._scaler_state: Optional[ScalerState] = None
        self._master_grads: Optional[torch.Tensor] = None

    # -- binding -----------------------------------------------------------
    def setup(self, params) -> None:
        """Attach the model's parameters (a module, or a list; half or
        fp32) and build the fp32 masters over them."""
        params = _param_list(params)
        layout = ChunkedFlatLayout(params)
        if layout.num_tensors != len(params):
            raise TypeError("FP16_Optimizer takes floating parameters only")
        masters = layout.pack([p.detach() for p in params])
        halves = {p.dtype for p in params if p.dtype != torch.float32}
        half_dtype = halves.pop() if len(halves) == 1 else None
        half = None if half_dtype is None else masters.to(half_dtype)
        self._copies = []
        with torch.no_grad():
            for p, m32, mh in zip(
                    params, layout.unpack(masters, cast_like=False),
                    layout.unpack(half, cast_like=False) if half is not None
                    else [None] * len(params)):
                if p.dtype == torch.float32:
                    p.data = m32
                elif p.dtype == half_dtype:
                    p.data = mh
                else:        # a second half dtype: copied after each step
                    self._copies.append((p, m32))
        self._params, self.masters, self._half = params, masters, half
        self._layout = layout
        self._inner_state = (self.optimizer.init(masters)
                             if self.optimizer.elementwise
                             else self.optimizer.init(masters, layout))
        self._scaler_state = self.loss_scaler.init_state(masters.device)
        self._grads = torch.empty_like(masters)

    def _require_setup(self) -> None:
        if self._params is None:
            raise RuntimeError("call setup(params) first")

    @property
    def params(self) -> Optional[List[torch.Tensor]]:
        return self._params

    @property
    def loss_scale(self) -> float:
        self._require_setup()
        return float(self._scaler_state.loss_scale)

    # -- the reference's 4-call protocol ------------------------------------
    def zero_grad(self) -> None:
        for p in self._params or ():
            p.grad = None
        self._master_grads = None

    def backward(self, loss: torch.Tensor,
                 update_master_grads: bool = True) -> None:
        """Backward of the scaled loss into the parameters' ``.grad`` (they
        accumulate across calls until ``zero_grad`` or a step), then, by
        default, :meth:`update_master_grads`."""
        self._require_setup()
        self.loss_scaler.scale_loss(loss, self._scaler_state).backward()
        if update_master_grads:
            self.update_master_grads()

    def update_master_grads(self) -> None:
        """The accumulated grads unscaled into the fp32 master grads, with
        the fused overflow check (one host read of its flag)."""
        self._require_setup()
        if all(p.grad is None for p in self._params):
            return
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self._params]
        flat = pack_flat(grads, out=self._grads)
        _, found = self.loss_scaler.unscale(flat, self._scaler_state,
                                            out=flat)
        self.overflow = bool(found > 0)
        self._master_grads = flat

    def clip_master_grads(self, max_norm: float,
                          norm_type: float = 2.0) -> torch.Tensor:
        """Clip the master grads by their global norm, in place; returns
        the norm before clipping."""
        if self._master_grads is None:
            raise RuntimeError("no master grads; call backward first")
        return clip_grad_norm(self._master_grads, max_norm, norm_type)

    def step(self, closure: Optional[Callable] = None):
        """Skip on overflow (the loss scale moves), else the inner step on
        the masters, which writes the model's copy."""
        if closure is not None:
            return self._step_with_closure(closure)
        self._require_setup()
        old_scale = self._scaler_state.loss_scale
        found = torch.full((), 1.0 if self.overflow else 0.0,
                           dtype=torch.float32, device=self.masters.device)
        self._scaler_state = self.loss_scaler.update(self._scaler_state,
                                                     found)
        if self.overflow:
            maybe_print(f"OVERFLOW! Skipping step. Attempted loss scale: "
                        f"{float(old_scale)}, reducing to {self.loss_scale}")
            self.zero_grad()
            self.overflow = False
            return None
        if self._master_grads is None:
            raise RuntimeError("step() called before backward()")
        self.optimizer.step(self.masters, self._inner_state,
                            self._master_grads, half=self._half)
        with torch.no_grad():
            for p, m in self._copies:
                p.copy_(m)
        self.zero_grad()
        return None

    def _step_with_closure(self, closure: Callable):
        # re-evaluate until a step without overflow applies
        while True:
            loss = closure()
            if not self.overflow:
                break
            found = torch.ones((), dtype=torch.float32,
                               device=self.masters.device)
            self._scaler_state = self.loss_scaler.update(
                self._scaler_state, found)
            maybe_print("OVERFLOW within closure! Retrying with loss scale "
                        f"{self.loss_scale}")
            self.zero_grad()
            self.overflow = False
        self.step()
        return loss

    # -- checkpoint: masters apart from the model's weights -----------------
    def state_dict(self) -> Dict[str, Any]:
        """References to the live state (clone, or save, before the next
        step), by the JAX package's keys."""
        self._require_setup()
        return {"loss_scaler": dict(vars(self._scaler_state)),
                "overflow": self.overflow,
                "first_closure_call_this_step":
                    self.first_closure_call_this_step,
                "optimizer_state": _state_to_dict(self._inner_state),
                "fp32_from_fp16": self._layout.unpack(self.masters,
                                                      cast_like=False)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy a state dict in place into the bound state; the model's
        parameters are re-derived from the loaded masters."""
        self._require_setup()
        dev = self.masters.device
        self._scaler_state = ScalerState(
            **{k: torch.as_tensor(v).to(dev).clone()
               for k, v in sd["loss_scaler"].items()})
        self.overflow = bool(sd["overflow"])
        self.first_closure_call_this_step = bool(
            sd["first_closure_call_this_step"])
        _load_state(self._inner_state, sd["optimizer_state"],
                    "optimizer_state")
        with torch.no_grad():
            for m, v in zip(self._layout.unpack(self.masters,
                                                cast_like=False),
                            sd["fp32_from_fp16"]):
                m.copy_(v)
            if self._half is not None:
                self._half.copy_(self.masters)
            for p, m in self._copies:
                p.copy_(m)
