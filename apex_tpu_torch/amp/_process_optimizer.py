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

Two call shapes.  ``step()`` after ``amp.scale_loss`` takes the grads
stashed by the backward passes (the torch shape).  ``step(scaled_grads)``
is the JAX package's functional step (``AmpOptimizer.step(params,
opt_state, grads)``): it packs the scaled grads that ``amp.scaled_grad``
gave into the flat fp32 stash, unscales them with the fused overflow
check, updates the loss scaler, steps the inner optimizer with the
overflow flag as its no-op, and returns ``info``.  Every piece of state
either form touches is written in place (the scalers, the moments, the
masters, ``last_info``) and neither depends on a host flag, so the
functional step can be captured in a CUDA graph and replayed.

The masters are the source of truth for the parameters.  A write of
parameter values after ``bind`` goes through :meth:`AmpOptimizer.
write_masters`, which sets the fp32 masters and re-derives the half copy
from them.  ``load_state_dict`` does so through pre-hooks that ``bind``
installs on every module that holds parameters, so a load reaches the
masters at full precision (not rounded through the half views) whether it
is called on the bound model, on one of its submodules, or on a wrapper
that holds it (``parallel.DistributedDataParallel``'s ``module.*`` keys);
``DistributedDataParallel``'s rank-0 broadcast takes the same route.

Checkpoints.  :meth:`AmpOptimizer.state_dict` holds the loss scalers (the
JAX package's ``{"scalers": [...]}``), the inner optimizer's state fields
and the flat fp32 master buffer: what the JAX package's ``AmpOptState``
(``inner``, ``masters``, ``scalers``) carries into a checkpoint.
:meth:`AmpOptimizer.load_state_dict` writes them in place into the bound
buffers, so every parameter stays a view into them.  The model's and the
optimizer's loads may come in either order: the model's leaves a half
parameter's masters alone when the value it brings is the one they
round to, so the optimizer's full-precision masters win.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .. import ops
from ..multi_tensor_apply import ChunkedFlatLayout, pack_flat
from ..multi_tensor_apply.flatten import ChunkedFlat
from ..optimizers.base import Optimizer
from .scaler import LossScaler, ScalerState
from .stateful import GradStash

__all__ = ["AmpOptimizer", "FlatMasters", "jax_leaf_order"]

_SCALER_FIELDS = {"loss_scale": torch.float32, "unskipped": torch.int32,
                  "steps_skipped": torch.int32}


def _state_to_dict(state: Any) -> Any:
    """An optimizer state (a dataclass of tensors, moments over a layout,
    a wrapped optimizer's state) as nested dicts of tensors; layouts,
    which the bound optimizer rebuilds, are left out."""
    if dataclasses.is_dataclass(state):
        return {f.name: _state_to_dict(getattr(state, f.name))
                for f in dataclasses.fields(state)
                if not isinstance(getattr(state, f.name), ChunkedFlatLayout)}
    if isinstance(state, ChunkedFlat):
        return state.buf
    return state


def _copy_into(dst: torch.Tensor, src, what: str) -> None:
    if not isinstance(src, torch.Tensor) or src.shape != dst.shape \
            or src.dtype != dst.dtype:
        got = (f"{tuple(src.shape)} {src.dtype}"
               if isinstance(src, torch.Tensor) else type(src).__name__)
        raise ValueError(f"{what}: the checkpoint holds {got}, the bound "
                         f"optimizer {tuple(dst.shape)} {dst.dtype} (another "
                         f"model or layout)")
    dst.copy_(src)


def _load_state(state: Any, sd: Any, what: str) -> None:
    """Copy ``sd`` (from :func:`_state_to_dict`) into ``state`` in place."""
    for f in dataclasses.fields(state):
        cur = getattr(state, f.name)
        if isinstance(cur, ChunkedFlatLayout):
            continue
        if not isinstance(sd, Mapping) or f.name not in sd:
            raise ValueError(f"{what}: the checkpoint has no {f.name!r}")
        new, name = sd[f.name], f"{what}.{f.name}"
        if dataclasses.is_dataclass(cur):
            _load_state(cur, new, name)
        elif isinstance(cur, ChunkedFlat):
            _copy_into(cur.buf, new, name)
        elif isinstance(cur, torch.Tensor):
            _copy_into(cur, new, name)
        elif new is not None or cur is not None:
            raise ValueError(f"{name}: the checkpoint holds "
                             f"{type(new).__name__}, the bound optimizer "
                             f"{type(cur).__name__}")


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

    or in the JAX package's functional shape::

        loss, grads = amp.scaled_grad(loss_fn, optimizer, x, y)
        info = optimizer.step(grads)

    After each step, ``last_info`` holds ``found_inf``, ``loss_scale``,
    ``steps_skipped`` and ``grad_norm`` (the l2norm of the unscaled
    grads) as 0-d device tensors, allocated at ``bind`` and rewritten in
    place by every step."""

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
        f32 = dict(dtype=torch.float32, device=device)
        self.last_info = {
            "found_inf": torch.zeros((), **f32),
            "loss_scale": torch.zeros((), **f32),
            "steps_skipped": torch.zeros((), dtype=torch.int32,
                                         device=device),
            "grad_norm": torch.zeros((), **f32)}
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
            if (p is None or not isinstance(v, torch.Tensor)
                    or v.shape != p.shape):
                continue
            # a half parameter loaded with the value it holds: its masters
            # already round to it, and keep their precision
            if p.dtype != torch.float32 and torch.equal(
                    v.detach().to(p.device, p.dtype), p.detach()):
                continue
            values[qualified + name] = v
        self.write_masters(values)

    def _require_bound(self) -> None:
        if self.masters is None:
            raise RuntimeError("AmpOptimizer is not bound to a model: get it "
                               "from amp.initialize(model, optimizer)")

    # -- checkpoints ------------------------------------------------------------
    def scalers_state_dict(self) -> List[Dict[str, torch.Tensor]]:
        """The loss scalers as the JAX package's ``amp.state_dict`` holds
        them: one ``{"loss_scale", "unskipped", "steps_skipped"}`` a loss."""
        self._require_bound()
        return [{k: getattr(s, k) for k in _SCALER_FIELDS}
                for s in self.scalers]

    def load_scalers_state_dict(self, scalers) -> None:
        self._require_bound()
        if len(scalers) != self.num_losses:
            raise ValueError(f"{len(scalers)} loss scalers for "
                             f"{self.num_losses} losses")
        # in place: a captured step reads these tensors' addresses
        for s, d in zip(self.scalers, scalers):
            for k, dt in _SCALER_FIELDS.items():
                t = getattr(s, k)
                t.copy_(torch.as_tensor(d[k]).to(device=t.device, dtype=dt))

    def state_dict(self) -> Dict[str, Any]:
        """``{"scalers": [...], "inner": {...}, "masters": buf}``: the loss
        scalers, the inner optimizer's state fields (FusedAdam's ``step``,
        ``m``, ``v``; LAMB's, SGD's, LARC's) and the flat fp32 master
        buffer.  References to the live tensors, as ``torch.optim``
        gives; ``torch.save`` them, or clone, before the next step."""
        self._require_bound()
        return {"scalers": self.scalers_state_dict(),
                "inner": _state_to_dict(self.state),
                "masters": self.masters.buf}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        """Load what :meth:`state_dict` gave, in place: the masters into the
        flat buffer (and the half copy re-derived from them), the inner
        state into its tensors, and the scalers.  Raises ``ValueError`` on
        a checkpoint of another layout.  A ``None`` master buffer (a JAX
        run without masters, see ``utils.jax_interop``) leaves the
        parameters to the model's own ``load_state_dict``."""
        self._require_bound()
        m = self.masters
        if sd.get("masters") is not None:
            _copy_into(m.buf, sd["masters"], "masters")
            if m.half is not None:
                m.half.copy_(m.buf)
        _load_state(self.state, sd["inner"], "inner")
        self.load_scalers_state_dict(sd["scalers"])

    def loss_scale(self, loss_id: int = 0) -> torch.Tensor:
        """The loss scale of ``loss_id`` now, as a 0-d device tensor: a
        copy, since the scaler's own tensor changes in place each step."""
        self._require_bound()
        return self.scalers[loss_id].loss_scale.clone()

    # -- driven by amp.scale_loss ----------------------------------------------
    def _prepare_backward(self) -> None:
        self._require_bound()
        for p in self._params:
            p.grad = None

    def _post_backward(self, loss_id: int, delay_unscale: bool) -> None:
        self._stash.add(self._params, self.scaler, self.scalers[loss_id])
        if not delay_unscale:
            self.scaler.update_(self.scalers[loss_id],
                                self._stash.found_inf)

    # -- torch-shaped methods ---------------------------------------------------
    def zero_grad(self, set_to_none: bool = True) -> None:
        self._require_bound()
        for p in self._params:
            p.grad = None
        self._stash.clear()

    def step(self, scaled_grads=None, loss_id: int = 0,
             found_inf_extra: Optional[torch.Tensor] = None):
        """With no argument, the torch shape: step on the grads that
        ``amp.scale_loss`` stashed (and return ``None``).

        With ``scaled_grads``, the JAX package's functional step
        (``_process_optimizer.py:584-815`` there): grads of ``loss *
        loss_scale`` with respect to the bound parameters, as
        ``amp.scaled_grad`` returns them: a list in the layout's order
        (``masters.layout.names``) or a mapping of those names to tensors
        (``None`` is a zero grad).  They are packed into the flat fp32
        stash, unscaled by the scaler of ``loss_id`` with the fused
        overflow check (OR-ed with ``found_inf_extra``, a 0-d flag of
        other overflow sources), the scaler is updated in place, and the
        inner optimizer steps with the overflow flag as its no-op.
        Returns ``info``, a new dict of copies of ``last_info``'s tensors
        (``found_inf``, ``loss_scale``, ``steps_skipped`` and
        ``grad_norm``), as the JAX step returns new arrays: the next step
        rewrites ``last_info`` in place, not the caller's ``info``."""
        self._require_bound()
        if scaled_grads is None:
            if found_inf_extra is not None or loss_id != 0:
                raise TypeError("loss_id and found_inf_extra belong to the "
                                "functional step: step(scaled_grads, ...)")
            self._eager_step()
            return None
        grads = self._stash.grads
        pack_flat(self._grad_list(scaled_grads), out=grads)
        sstate = self.scalers[loss_id]
        # in place: the packed scaled grads are not needed afterwards
        _, found = self.scaler.unscale(grads, sstate, out=grads)
        if found_inf_extra is not None:
            found = torch.maximum(found, found_inf_extra.to(found.dtype))
        self.scaler.update_(sstate, found)
        self._apply(grads, found, sstate)
        return {k: t.clone() for k, t in self.last_info.items()}

    def _grad_list(self, grads) -> List[torch.Tensor]:
        """``grads`` in layout order, zeros for a missing grad."""
        if isinstance(grads, Mapping):
            names = self.masters.layout.names
            unknown = sorted(set(grads) - set(names))
            if unknown:
                raise KeyError(f"grads of no bound parameter: {unknown[:8]}")
            grads = [grads.get(n) for n in names]
        grads = list(grads)
        if len(grads) != len(self._params):
            raise ValueError(f"{len(grads)} grads for {len(self._params)} "
                             f"bound parameters")
        out = []
        for g, p in zip(grads, self._params):
            if g is None:
                g = torch.zeros_like(p)
            elif g.shape != p.shape:
                raise ValueError(f"a grad of shape {tuple(g.shape)} for a "
                                 f"parameter of shape {tuple(p.shape)}")
            out.append(g)
        return out

    def _eager_step(self) -> None:
        if not self._stash.has_grads:
            raise RuntimeError("step() called before backward()")
        stash = self._stash
        self._apply(stash.grads, stash.found_inf, self.scalers[0])
        stash.clear()

    def _apply(self, grads: torch.Tensor, found: torch.Tensor,
               sstate: ScalerState) -> None:
        """The inner step on the unscaled flat fp32 ``grads``, skipped on
        the device when ``found`` is set; ``last_info`` written."""
        masters = self.masters
        # of the unscaled fp32 grads, before the no-master path rounds them
        grad_norm = ops.multi_tensor_l2norm(grads)
        if not self.master_weights:
            self.refresh_masters()   # the update starts from the half params
            for off, n in self._half_spans:
                grads[off:off + n] = grads[off:off + n].to(
                    masters.half.dtype).float()
        self.inner.step(masters.buf, self.state, grads, half=masters.half,
                        noop=found)
        info = self.last_info
        info["found_inf"].copy_(found)
        info["loss_scale"].copy_(sstate.loss_scale)
        info["steps_skipped"].copy_(sstate.steps_skipped)
        info["grad_norm"].copy_(grad_norm)
