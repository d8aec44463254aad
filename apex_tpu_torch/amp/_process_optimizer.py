"""AmpOptimizer: fp32 master weights, unscale, overflow skip.

Counterpart of ``apex_tpu/amp/_process_optimizer.py`` on its flat,
non-ZeRO path.  At :meth:`AmpOptimizer.bind` (called by
``amp.initialize``) the model's parameters are laid out, in the JAX
package's leaf order, in one flat fp32 master buffer, plus one flat
buffer of the half dtype when the model has one (O2).  The model's half
parameters then become views into the half buffer and its fp32
parameters (BatchNorm under O2; everything under O0) views into the
master buffer.  The optimizer's kernel (Adam, or LAMB's stage 2) updates
the masters in place and writes the half copy in the same pass, so the
model is updated in place with no rebuild copy: the in-place update the
port allows where it saves memory (here the whole per-step params rebuild
of ``_FlatLayout.rebuild``).  The masters stay dense for every optimizer:
one that is not elementwise (FusedLAMB, LARC) gets the layout, whose
chunk table carries the tensor boundaries, where the JAX package keeps a
master tree for it.

A step is free of host syncs: unscale and overflow check in one kernel,
the scaler's transition on device tensors, and a skipped step is the
optimizer kernels' no-op flag (the JAX package's ``lax.cond``).

The masters are the source of truth for the parameters.  A write of
parameter values after ``bind`` goes through :meth:`AmpOptimizer.
write_masters`, which sets the fp32 masters and re-derives the half copy
from them.  ``load_state_dict`` does so through pre-hooks that ``bind``
installs on every module that holds parameters, so a load reaches the
masters at full precision (not rounded through the half views) whether it
is called on the bound model, on one of its submodules, or on a wrapper
that holds it (``parallel.DistributedDataParallel``'s ``module.*`` keys);
``DistributedDataParallel``'s rank-0 broadcast takes the same route.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .. import ops
from ..multi_tensor_apply import ChunkedFlatLayout
from ..optimizers.base import Optimizer
from .scaler import LossScaler, ScalerState
from .stateful import GradStash

__all__ = ["AmpOptimizer", "FlatMasters", "jax_leaf_order"]


def jax_leaf_order(names: Sequence[str]) -> List[str]:
    """``jax.tree_util`` flattens nested dicts with the keys of each level
    sorted as strings (so a Bottleneck's leaves go bn1, bn2, bn3, conv1,
    ..., downsample, and a Sequential's child "10" comes before "2").
    Sorting dotted names by their tuple of components gives that order."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


class _FlatLayout(ChunkedFlatLayout):
    """The dense flat layout of the named parameters in the JAX package's
    leaf order, computed once at bind; as a ``ChunkedFlatLayout`` it also
    tells a non-elementwise optimizer where each tensor lies."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]]):
        by_name = dict(named_params)
        self.names = tuple(jax_leaf_order(by_name))
        super().__init__([by_name[n] for n in self.names])
        halves = {d for d, f in zip(self.dtypes, self.is_float)
                  if f and d != torch.float32}
        # the single non-fp32 float dtype (O2's cast_model_type), if any:
        # the optimizer's kernel writes the half model copy in its pass
        self.half_dtype = halves.pop() if len(halves) == 1 else None

    def pieces(self, flat: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """Per-leaf views of a flat buffer (None for non-float leaves)."""
        return self.unpack(flat, cast_like=False)


class FlatMasters:
    """fp32 master weights as one flat buffer, the optional flat half
    copy the model's half parameters view, and their layout."""

    def __init__(self, buf: torch.Tensor, half: Optional[torch.Tensor],
                 layout: _FlatLayout):
        self.buf = buf
        self.half = half
        self.layout = layout

    def as_list(self) -> List[torch.Tensor]:
        return [p for p in self.layout.pieces(self.buf) if p is not None]


class AmpOptimizer:
    """Wraps a port optimizer with loss scaling and flat fp32 masters, in
    the torch shape::

        with amp.scale_loss(loss, optimizer) as scaled_loss:
            scaled_loss.backward()
        optimizer.step()
        optimizer.zero_grad()

    After each step, ``last_info`` holds ``found_inf``, ``loss_scale``,
    ``steps_skipped`` and ``grad_norm`` (the l2norm of the unscaled
    grads) as device tensors."""

    def __init__(self, inner: Optimizer, scaler: LossScaler,
                 master_weights: bool, num_losses: int = 1):
        self.inner = inner
        self.scaler = scaler
        self.master_weights = bool(master_weights)
        self.num_losses = int(num_losses)
        self.masters: Optional[FlatMasters] = None
        self.state = None
        self.scalers: List[ScalerState] = []
        self.last_info: Dict[str, torch.Tensor] = {}
        self._params: List[torch.nn.Parameter] = []
        self._stash: Optional[GradStash] = None

    # -- set-up ---------------------------------------------------------------
    def bind(self, model: torch.nn.Module) -> None:
        if self.masters is not None:
            raise RuntimeError("this optimizer is already bound to a model")
        named = list(model.named_parameters())
        if not named:
            raise ValueError("the model has no parameters")
        layout = _FlatLayout(named)
        by_name = dict(named)
        params = [by_name[n] for n in layout.names]
        device = params[0].device
        buf = layout.pack([p.detach() for p in params])
        half = (None if layout.half_dtype is None
                else buf.to(layout.half_dtype))
        # the model's parameters become views into the flat buffers (the
        # casts above are exact: fp32 holds every bf16/fp16 value)
        for p, p32, ph in zip(params, layout.pieces(buf),
                              layout.pieces(half) if half is not None
                              else [None] * len(params)):
            p.data = p32 if p.dtype == torch.float32 else ph
        self.masters = FlatMasters(buf, half, layout)
        # an optimizer with per-tensor semantics (LAMB, LARC) also gets the
        # tensor boundaries (the JAX package gives it the master tree)
        self.state = (self.inner.init(buf) if self.inner.elementwise
                      else self.inner.init(buf, layout))
        self.scalers = [self.scaler.init_state(device)
                        for _ in range(self.num_losses)]
        self._params = params
        self._stash = GradStash(layout.total, device)
        # without masters the update starts from the half params each step
        # (the JAX package's no-master path): the spans to refresh
        self._half_spans = [
            (off, n) for d, off, n in zip(layout.dtypes, layout.offsets,
                                          layout.sizes)
            if d == layout.half_dtype and n]
        self._index = {n: i for i, n in enumerate(layout.names)}
        model._amp_optimizer = self
        for mname, mod in model.named_modules():
            if any(p is not None for p in mod._parameters.values()):
                mod.register_load_state_dict_pre_hook(functools.partial(
                    self._load_state_dict_hook, mname + "." if mname else ""))

    # -- parameter values after bind ------------------------------------------
    def refresh_masters(self) -> None:
        """Without master weights the half params are the source of truth:
        copy them into the masters' spans (the no-master path's update
        starts from them).  With master weights, nothing to do."""
        self._require_bound()
        if not self.master_weights:
            m = self.masters
            for off, n in self._half_spans:
                m.buf[off:off + n].copy_(m.half[off:off + n])

    def write_masters(self, values: Mapping[str, torch.Tensor]) -> None:
        """Set parameter values after ``bind``: ``values`` maps parameter
        names (as the bound model's ``named_parameters`` gives them) to
        tensors; names of no parameter, and ``None`` values, are ignored.
        Each value is written into the fp32 masters, then its span of the
        half copy, which the model's half parameters view, is re-derived
        from the masters."""
        self._require_bound()
        m = self.masters
        lay = m.layout
        for name, v in values.items():
            i = self._index.get(name)
            if v is None or i is None or not lay.is_float[i]:
                continue
            off, n = lay.offsets[i], lay.sizes[i]
            m.buf[off:off + n].copy_(v.detach().reshape(-1))
            if m.half is not None:
                m.half[off:off + n].copy_(m.buf[off:off + n])

    def _load_state_dict_hook(self, qualified: str, module, state_dict,
                              prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs) -> None:
        """``module``'s own parameters: ``prefix + name`` in the state dict
        is the bound model's ``qualified + name``."""
        if local_metadata.get("assign_to_params_buffers", False):
            raise RuntimeError("load_state_dict(assign=True) would replace "
                               "the parameters, which are views into the "
                               "optimizer's flat buffers after "
                               "amp.initialize")
        values = {}
        for name, p in module._parameters.items():
            v = state_dict.get(prefix + name)
            # a mismatched shape is left to the default load to report
            if (p is not None and isinstance(v, torch.Tensor)
                    and v.shape == p.shape):
                values[qualified + name] = v
        self.write_masters(values)

    def _require_bound(self) -> None:
        if self.masters is None:
            raise RuntimeError("AmpOptimizer is not bound to a model: get it "
                               "from amp.initialize(model, optimizer)")

    def loss_scale(self, loss_id: int = 0) -> torch.Tensor:
        self._require_bound()
        return self.scalers[loss_id].loss_scale

    # -- driven by amp.scale_loss ----------------------------------------------
    def _prepare_backward(self) -> None:
        self._require_bound()
        for p in self._params:
            p.grad = None

    def _post_backward(self, loss_id: int, delay_unscale: bool) -> None:
        self._stash.add(self._params, self.scaler, self.scalers[loss_id])
        if not delay_unscale:
            self.scalers[loss_id] = self.scaler.update(
                self.scalers[loss_id], self._stash.found_inf)

    # -- torch-shaped methods ---------------------------------------------------
    def zero_grad(self, set_to_none: bool = True) -> None:
        self._require_bound()
        for p in self._params:
            p.grad = None
        self._stash.clear()

    def step(self) -> None:
        self._require_bound()
        if not self._stash.has_grads:
            raise RuntimeError("step() called before backward()")
        masters, stash = self.masters, self._stash
        grads, found = stash.grads, stash.found_inf
        # of the unscaled fp32 grads, before the no-master path rounds them
        grad_norm = ops.multi_tensor_l2norm(grads)
        if not self.master_weights:
            self.refresh_masters()   # the update starts from the half params
            for off, n in self._half_spans:
                grads[off:off + n] = grads[off:off + n].to(
                    masters.half.dtype).float()
        self.inner.step(masters.buf, self.state, grads, half=masters.half,
                        noop=found)
        s = self.scalers[0]
        self.last_info = {"found_inf": found.clone(),
                          "loss_scale": s.loss_scale,
                          "steps_skipped": s.steps_skipped,
                          "grad_norm": grad_norm}
        stash.clear()
