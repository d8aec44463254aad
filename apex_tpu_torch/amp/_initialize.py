"""Model and optimizer ingestion for ``amp.initialize``.

Counterpart of ``apex_tpu/amp/_initialize.py``.  Where the JAX package
returns an ``AmpModel`` that casts a functional params tree, the port
does what the reference Apex does to a ``torch.nn.Module``: cast its
parameters in place (modules with ``fp32_params = True``, i.e. BatchNorm,
stay fp32 under ``keep_batchnorm_fp32``; buffers are never cast, as the
JAX state dict is not) and patch its ``forward`` to cast floating inputs
to the model dtype and outputs back to fp32.  The module keeps its class
and its ``state_dict`` names.  O1 casts no parameter and patches no
forward: it installs the process-wide ``policy.CastPolicy``, the analogue
of the reference's monkey-patching.  Lists of models and optimizers are
wrapped one by one and returned in the caller's shape; each optimizer is
bound to the model at its index.
"""

from __future__ import annotations

import functools
import torch

from . import policy as _policy
from ._process_optimizer import AmpOptimizer
from .frontend import Properties
from .scaler import LossScaler

__all__ = ["cast_model", "_initialize"]


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
            args = _policy._cast_tree(args, in_dtype)
            kwargs = _policy._cast_tree(kwargs, in_dtype)
        out = forward(*args, **kwargs)
        return (out if out_dtype is None
                else _policy._cast_tree(out, out_dtype))

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
    single_model = not isinstance(model, (list, tuple))
    models = [model] if single_model else list(model)
    for m in models:
        if not isinstance(m, torch.nn.Module):
            raise TypeError(f"amp.initialize expected a torch.nn.Module, "
                            f"got {type(m).__name__}")
        if getattr(m, "_amp_initialized", False):
            raise RuntimeError("amp.initialize should be called only once; "
                               "received an already-initialized model.")
    single_opt = not isinstance(optimizers, (list, tuple))
    opts = ([] if optimizers is None
            else [optimizers] if single_opt else list(optimizers))
    if opts and len(opts) != len(models):
        raise ValueError(
            f"amp.initialize binds each optimizer to one model's "
            f"parameters: got {len(models)} model(s) and {len(opts)} "
            f"optimizer(s)")
    wrapped = [_wrap_optimizer(o, properties, disabled) for o in opts]

    ct = None if disabled else properties.options.get("cast_model_type")
    for m in models:
        if ct is not None:
            cast_model(m, ct, properties.keep_batchnorm_fp32)
            half_model = ct != torch.float32
            co = properties.options.get("cast_model_outputs")
            # O2/O3 cast model outputs back to fp32 so losses run in fp32
            _patch_forward(m, ct if half_model else None,
                           co if co is not None else
                           (torch.float32 if half_model else None))
        m._amp_initialized = True
    for m, o in zip(models, wrapped):
        o.bind(m)

    if properties.patch_torch_functions and not disabled:
        # the process-wide O1 policy, the analogue of amp.init()'s
        # monkey-patching (apex/amp/amp.py:68-177)
        _policy.set_policy(_policy.CastPolicy(properties.half_torch_dtype))

    out_model = models[0] if single_model else models
    if optimizers is None:
        return out_model
    return out_model, (wrapped[0] if single_opt else wrapped)
