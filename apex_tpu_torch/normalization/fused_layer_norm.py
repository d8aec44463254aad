"""FusedLayerNorm: layer norm whose forward and backward are the LayerNorm
kernels.

Counterpart of ``apex_tpu/normalization/fused_layer_norm.py``, with the
reference's contract: the input viewed as (n1, n2) = (rows, normalized
size), fp32 (mean, inv) saved per row for the backward even for half
inputs, and the backward's (dx, dgamma, dbeta).  The autograd op runs
``ops.layer_norm_fwd`` / ``ops.layer_norm_bwd`` (the kernels on the card,
their plain versions on the CPU); the output is cast to x's dtype and
dgamma/dbeta to the weight's and bias's dtypes, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from .. import ops

__all__ = ["FusedLayerNorm", "fused_layer_norm", "fused_layer_norm_affine"]


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, bias, eps):
        x2 = x2.contiguous()
        w32 = _f32(weight)
        y, mean, inv = ops.layer_norm_fwd(x2, w32, _f32(bias), eps)
        ctx.save_for_backward(x2, w32, mean, inv)
        ctx.dtypes = (None if weight is None else weight.dtype,
                      None if bias is None else bias.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w32, mean, inv = ctx.saved_tensors
        dx, dw, db = ops.layer_norm_bwd(dy.contiguous(), x2, w32, mean, inv)
        wd, bd = ctx.dtypes
        return (dx, None if wd is None else dw.to(wd),
                None if bd is None else db.to(bd), None)


def fused_layer_norm(x: torch.Tensor,
                     normalized_shape: Union[int, Sequence[int]],
                     weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the trailing ``normalized_shape`` dims (affine when
    weight/bias are given)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n2 = math.prod(normalized_shape)
    x2 = x.reshape(-1, n2)
    w = weight.reshape(-1) if weight is not None else None
    b = bias.reshape(-1) if bias is not None else None
    return _LayerNorm.apply(x2, w, b, float(eps)).reshape(x.shape)


def fused_layer_norm_affine(x, weight, bias, normalized_shape, eps=1e-5):
    return fused_layer_norm(x, normalized_shape, weight, bias, eps)


class FusedLayerNorm(torch.nn.Module):
    """Module parity with apex.normalization.FusedLayerNorm: the same
    constructor, affine and not.  ``fp32_params``: amp keeps the weight
    and bias fp32 under ``keep_batchnorm_fp32``, as the JAX package does."""

    fp32_params = True

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True, *,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            f32 = dict(dtype=torch.float32, device=device)
            self.weight = torch.nn.Parameter(
                torch.ones(self.normalized_shape, **f32))
            self.bias = torch.nn.Parameter(
                torch.zeros(self.normalized_shape, **f32))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        return fused_layer_norm(x, self.normalized_shape, self.weight,
                                self.bias, self.eps)
