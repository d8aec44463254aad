"""The manual master-parameter toolkit.

Counterpart of ``apex_tpu/fp16_utils/fp16util.py``, on ``torch.nn.Module``s
and lists of tensors where the JAX package takes pytrees: the master copy
is a list of fp32 tensors (or one flat fp32 tensor with ``flat_master``),
the model's parameters are written in place, as the reference Apex writes
them, and "half precision with fp32 BatchNorm" casts a module's
parameters in place.  The argument order is the JAX package's
(``master_params_to_model_params(master, model_params)``).

``clip_grad_norm`` scales the grads in place by ``min(max_norm / (total +
1e-6), 1)`` and returns ``total``, the norm before clipping: the 2-norm
over one flat fp32 buffer (or a list packed into one) is the l2norm kernel
on the card; the inf-norm and the p-norms are torch ops.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple, Union

import torch

from .. import ops
from ..multi_tensor_apply import pack_flat, unpack_flat

__all__ = [
    "prep_param_lists", "model_grads_to_master_grads",
    "master_params_to_model_params", "network_to_half", "convert_network",
    "FP16Model", "tofp16", "BN_convert_float", "clip_grad_norm",
]

Params = Union[torch.nn.Module, Iterable[torch.Tensor]]


def _param_list(model_params: Params) -> List[torch.Tensor]:
    if isinstance(model_params, torch.nn.Module):
        return [p for p in model_params.parameters() if p.requires_grad]
    return list(model_params)


def prep_param_lists(model_params: Params, flat_master: bool = False
                     ) -> Tuple[List[torch.Tensor], Union[
                         List[torch.Tensor], torch.Tensor]]:
    """``(model_params, master)``: the module's trainable parameters (or
    the given tensors) as a list, and their fp32 copy, a list of tensors
    or, with ``flat_master``, one fp32 vector of them all (the params must
    then share one dtype)."""
    params = _param_list(model_params)
    if flat_master:
        dtypes = {p.dtype for p in params}
        if len(dtypes) > 1:
            raise TypeError("flat_master requires a single param dtype "
                            f"(got {sorted(map(str, dtypes))})")
        return params, pack_flat([p.detach() for p in params],
                                 torch.float32)
    return params, [p.detach().float().clone() for p in params]


def model_grads_to_master_grads(model_grads: Iterable[torch.Tensor], master,
                                flat_master: bool = False):
    """The half grads cast into the master's fp32 structure, also set as
    the masters' ``.grad`` (where the reference Apex writes them); a
    missing grad is zeros (in the list form)."""
    grads = list(model_grads)
    if flat_master:
        out = pack_flat(grads, torch.float32)
        master.grad = out
        return out
    out = []
    for g, m in zip(grads, master):
        g32 = torch.zeros_like(m) if g is None else g.detach().float()
        m.grad = g32
        out.append(g32)
    return out


@torch.no_grad()
def master_params_to_model_params(master, model_params: Params,
                                  flat_master: bool = False
                                  ) -> List[torch.Tensor]:
    """Copy the master values into the model's parameters, in place, in
    their dtypes; returns the parameters."""
    params = _param_list(model_params)
    pieces = (unpack_flat(master, params) if flat_master else list(master))
    for p, m in zip(params, pieces):
        p.copy_(m)
    return params


def tofp16(x, half_dtype: torch.dtype = torch.float16):
    """Every floating tensor of ``x`` (a tensor or a list) cast to half;
    others pass through."""
    def cast(t):
        return (t.to(half_dtype) if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t)
    return cast(x) if isinstance(x, torch.Tensor) else [cast(t) for t in x]


def _is_batchnorm(mod: torch.nn.Module) -> bool:
    return (getattr(mod, "fp32_params", False)
            or isinstance(mod, torch.nn.modules.batchnorm._BatchNorm))


def BN_convert_float(module: torch.nn.Module) -> torch.nn.Module:
    """Put the BatchNorm parameters of ``module`` back in fp32, in place;
    returns the module."""
    for mod in module.modules():
        if _is_batchnorm(mod):
            for p in mod.parameters(recurse=False):
                p.data = p.data.float()
    return module


def convert_network(module: torch.nn.Module,
                    dtype: torch.dtype = torch.float16) -> torch.nn.Module:
    """Cast every floating parameter of ``module`` to ``dtype`` in place,
    BatchNorm's excepted; returns the module."""
    for mod in module.modules():
        if _is_batchnorm(mod):
            continue
        for p in mod.parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return module


def network_to_half(module: torch.nn.Module,
                    half_dtype: torch.dtype = torch.float16
                    ) -> torch.nn.Module:
    """Half parameters with fp32 BatchNorm (``convert_network``)."""
    return convert_network(module, half_dtype)


class FP16Model(torch.nn.Module):
    """Runs ``module`` in half precision (fp32 BatchNorm) on inputs cast
    to half."""

    def __init__(self, module: torch.nn.Module,
                 half_dtype: torch.dtype = torch.float16):
        super().__init__()
        self.half_dtype = half_dtype
        self.network = convert_network(module, half_dtype)

    def forward(self, *args, **kwargs):
        args = tofp16(list(args), self.half_dtype)
        kwargs = {k: tofp16(v, self.half_dtype)
                  if isinstance(v, torch.Tensor) else v
                  for k, v in kwargs.items()}
        return self.network(*args, **kwargs)


def clip_grad_norm(grads, max_norm: float,
                   norm_type: float = 2.0) -> torch.Tensor:
    """Clip ``grads`` (a tensor or a list) by their global norm, in place;
    returns the norm before clipping as a 0-d fp32 tensor."""
    grads = [grads] if isinstance(grads, torch.Tensor) else list(grads)
    if norm_type == 2.0:
        flat = (grads[0] if len(grads) == 1 and grads[0].dim() == 1
                and grads[0].dtype == torch.float32
                else pack_flat(grads, torch.float32))
        total = ops.multi_tensor_l2norm(flat)
    elif norm_type == float("inf"):
        total = torch.stack([g.float().abs().max() for g in grads]).max()
    else:
        total = sum(torch.sum(g.float().abs() ** norm_type)
                    for g in grads) ** (1.0 / norm_type)
    coef = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    with torch.no_grad():
        for g in grads:
            g.copy_((g.float() * coef).to(g.dtype))
    return total
