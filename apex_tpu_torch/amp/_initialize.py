"""Model and optimizer ingestion for ``amp.initialize``.

Counterpart of ``apex_tpu/amp/_initialize.py``.  Where the JAX package
returns an ``AmpModel`` that casts a functional params tree, the port
does what the reference Apex does to a ``torch.nn.Module``: cast its
parameters in place (modules with ``fp32_params = True``, i.e. BatchNorm,
stay fp32 under ``keep_batchnorm_fp32``; buffers are never cast, as the
JAX state dict is not) and patch its ``forward`` to cast floating inputs
to the model dtype and outputs back to fp32.  The module keeps its class
and its ``state_dict`` names.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from ._process_optimizer import AmpOptimizer
from .frontend import Properties
from .scaler import LossScaler

__all__ = ["cast_model", "_initialize"]


def _cast_floats(obj: Any, dtype: torch.dtype) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cast_floats(o, dtype) for o in obj)
    if isinstance(obj, dict):
        return {k: _cast_floats(v, dtype) for k, v in obj.items()}
    return obj


def cast_model(model: torch.nn.Module, dtype: torch.dtype,
               keep_batchnorm_fp32) -> None:
    """Cast every floating parameter of ``model`` to ``dtype`` in place,
    skipping fp32-pinned modules when ``keep_batchnorm_fp32``."""
    keep = bool(keep_batchnorm_fp32) and dtype != torch.float32
    for mod in model.modules():
        if keep and getattr(mod, "fp32_params", False):
            continue
        for p in mod.parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)


def _patch_forward(model: torch.nn.Module, in_dtype, out_dtype) -> None:
    forward = model.forward

    @functools.wraps(forward)
    def amp_forward(*args, **kwargs):
        if in_dtype is not None:
            args = _cast_floats(args, in_dtype)
            kwargs = _cast_floats(kwargs, in_dtype)
        out = forward(*args, **kwargs)
        return out if out_dtype is None else _cast_floats(out, out_dtype)

    model.forward = amp_forward


def _wrap_optimizer(opt, props: Properties, disabled: bool) -> AmpOptimizer:
    if isinstance(opt, AmpOptimizer):
        raise RuntimeError("amp.initialize should be called only once; "
                           "received an already-wrapped optimizer.")
    if disabled:
        return AmpOptimizer(opt, LossScaler(1.0), master_weights=False,
                            num_losses=props.num_losses)
    scaler = LossScaler(
        props.loss_scale if props.loss_scale is not None else "dynamic",
        min_loss_scale=props.min_loss_scale,
        max_loss_scale=props.max_loss_scale)
    return AmpOptimizer(opt, scaler, master_weights=bool(props.master_weights),
                        num_losses=props.num_losses)


def _initialize(model, optimizers, properties: Properties,
                disabled: bool = False):
    if not isinstance(model, torch.nn.Module):
        raise TypeError(f"amp.initialize expected one torch.nn.Module, got "
                        f"{type(model).__name__} (lists of models are not "
                        f"ported yet)")
    if getattr(model, "_amp_initialized", False):
        raise RuntimeError("amp.initialize should be called only once; "
                           "received an already-initialized model.")
    if isinstance(optimizers, (list, tuple)):
        raise NotImplementedError("pass one optimizer to amp.initialize "
                                  "(lists are not ported yet)")

    ct = None if disabled else properties.options.get("cast_model_type")
    if ct is not None:
        cast_model(model, ct, properties.keep_batchnorm_fp32)
        half_model = ct != torch.float32
        co = properties.options.get("cast_model_outputs")
        # O2/O3 cast model outputs back to fp32 so losses run in fp32
        _patch_forward(model, ct if half_model else None,
                       co if co is not None else
                       (torch.float32 if half_model else None))
    model._amp_initialized = True

    if optimizers is None:
        return model
    amp_opt = _wrap_optimizer(optimizers, properties, disabled)
    amp_opt.bind(model)
    return model, amp_opt
