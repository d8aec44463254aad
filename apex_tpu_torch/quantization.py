"""Weight-only int8 quantization for decoding.

Counterpart of ``apex_tpu/quantization.py``: symmetric per-channel int8
with fp32 scales, rounded to nearest (ties to even) and clipped to +-127.
Decoding re-reads every weight for every token, so int8 storage halves
the bytes a bf16 weight costs.  The consumers dequantize where the JAX
package's do: ``nn.functional.linear`` dequantizes the whole weight, then
multiplies (plain torch ops, as the JAX package leaves this to XLA,
outside any Pallas kernel); ``nn.functional.embedding`` gathers int8 rows
and converts only those; the LM heads dequantize the table.

    qmodel = quantization.quantize_for_decode(model)
    ids, n = qmodel.generate_cached(buf, prompt_len, 64)

``QTensor`` is a ``torch.nn.Module`` holding two buffers, ``data`` (int8)
and ``scale`` (fp32), where the JAX package has a pytree node: a
quantized model's ``state_dict`` names them ``<path>.weight.data`` and
``<path>.weight.scale``, and ``.to(device)`` moves them.  A cast of the
model (``.to(dtype)``, ``.half()``) leaves both dtypes as they are: the
logical dtype, what consumers see after dequantizing, is fixed when the
weight is quantized.
"""

from __future__ import annotations

import copy

import torch

__all__ = ["QTensor", "quantize", "quantize_for_decode"]


class QTensor(torch.nn.Module):
    """int8 ``data`` and an fp32 ``scale`` of the same rank (size 1 except
    on ``axis``), dequantizing to ``dtype`` on use."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor, axis: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.register_buffer("data", data)
        self.register_buffer("scale", scale)
        self.axis = axis
        self._dtype = dtype

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self) -> int:
        return self.data.dim()

    @property
    def dtype(self) -> torch.dtype:
        """The logical dtype: what consumers see after dequantizing."""
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def dequant(self, dtype=None) -> torch.Tensor:
        """``data * scale`` in ``dtype`` (default the logical one), each
        cast to it before the multiply, as the JAX package computes it."""
        d = dtype or self._dtype
        return self.data.to(d) * self.scale.to(d)

    @property
    def T(self) -> torch.Tensor:
        w = self.dequant()
        return w.permute(*reversed(range(w.dim())))

    def astype(self, dtype) -> torch.Tensor:
        return self.dequant(dtype)

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (an embedding lookup) without dequantizing the
        whole table: only the gathered rows convert."""
        if self.axis != 0:
            raise ValueError("take() needs per-row (axis=0) scales")
        ids = ids.long()
        return self.data[ids].to(self._dtype) * self.scale[ids].to(
            self._dtype)

    def _apply(self, fn, recurse=True):
        # a move changes the device; a cast is not applied (see the module
        # doc): the storage dtypes are the format
        for name in ("data", "scale"):
            t = self._buffers[name]
            moved = fn(t)
            if moved.dtype != t.dtype:
                moved = t.to(moved.device)
            self._buffers[name] = moved
        return self

    def extra_repr(self) -> str:
        return (f"int8{list(self.shape)}, axis={self.axis}, "
                f"dtype={str(self._dtype).replace('torch.', '')}")


def quantize(w: torch.Tensor, axis: int = 0,
             dtype: torch.dtype = torch.bfloat16) -> QTensor:
    """Symmetric per-channel int8: scale = amax/127 over every dim but
    ``axis`` (rows of an (out, in) Linear weight or a (V, D) table),
    floored at 1e-12; values rounded half to even and clipped to +-127."""
    w = torch.as_tensor(w).detach()
    reduce_dims = tuple(i for i in range(w.dim()) if i != axis)
    wf = w.float()
    amax = (wf.abs().amax(dim=reduce_dims, keepdim=True) if reduce_dims
            else wf.abs())
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which rounds apart from the CPU's (and the JAX
    # package's) true division
    scale = torch.div(torch.clamp_min(amax, 1e-12),
                      torch.full_like(amax, 127.0))
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return QTensor(q.to(torch.int8), scale, axis, dtype)


def _selected(w, min_size: int) -> bool:
    return (isinstance(w, torch.Tensor) and w.dim() == 2
            and w.numel() >= min_size and w.is_floating_point())


def quantize_for_decode(model: torch.nn.Module,
                        dtype: torch.dtype = torch.bfloat16,
                        min_size: int = 4096) -> torch.nn.Module:
    """A copy of ``model`` whose every floating 2-D ``weight`` of at least
    ``min_size`` elements (Linear matrices, embedding tables) is a
    ``QTensor``; 1-D parameters (norms, biases) and small tensors stay as
    they are.  ``model`` is left untouched.  The copy shares no tensor
    with it and holds no full-precision copy of a quantized weight: only
    one weight's fp32 temporary exists at a time besides the original.
    It shares the model's generators (dropout's, which decoding does not
    draw from)."""
    picked = {}
    for mod in model.modules():
        w = mod._parameters.get("weight")
        if _selected(w, min_size) and id(w) not in picked:
            picked[id(w)] = quantize(w, axis=0, dtype=dtype)
    # the deep copy takes None for each picked weight (the int8 one is
    # put in its place below) and shares an amp optimizer the model is
    # bound to instead of copying its state
    memo = dict.fromkeys(picked)
    for mod in model.modules():
        for v in vars(mod).values():
            if isinstance(v, torch.Generator):
                memo[id(v)] = v
    opt = getattr(model, "_amp_optimizer", None)
    if opt is not None:
        memo[id(opt)] = opt
    new = copy.deepcopy(model, memo)
    for old_mod, new_mod in zip(list(model.modules()), list(new.modules())):
        w = old_mod._parameters.get("weight")
        if w is not None and id(w) in picked:
            del new_mod._parameters["weight"]
            new_mod.weight = picked[id(w)]
        # the copy is bound to no optimizer (amp's load hooks write the
        # original's masters)
        new_mod._load_state_dict_pre_hooks.clear()
    if opt is not None:
        del new._amp_optimizer
    cast = getattr(model, "_amp_forward_dtypes", None)
    if cast is not None:
        # amp's patched forward calls the original module's: patch again
        from .amp._initialize import _patch_forward
        del new.__dict__["forward"]
        _patch_forward(new, *cast)
    return new
