"""Functional ops ResNet and BERT need, with the JAX package's numerics.

Counterpart of the ResNet and BERT subset of ``apex_tpu/nn/functional.py``.
Convolution and linear stay ``torch.nn.functional`` calls (the JAX package
leaves them to XLA, outside any Pallas kernel).  Batch norm follows the JAX
formula: single-pass fp32 statistics E[x^2] - mean^2 clamped at 0, in
torch ops, then the apply in fp32 cast back to the input dtype.  On NCHW
input the apply is ``ops.batch_norm_apply_fused`` (the syncbn kernels on
the card, their plain versions on the CPU); any other layout keeps
``y = x*scale + shift`` in torch ops.  cuDNN's ``F.batch_norm`` is not
used: its Welford statistics round differently.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as _F

from .. import ops

__all__ = ["conv2d", "linear", "relu", "batch_norm_stats", "batch_norm_apply",
           "max_pool2d", "adaptive_avg_pool2d", "cross_entropy", "gelu",
           "tanh", "embedding", "dropout", "log_softmax"]


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """NCHW convolution with OIHW weights."""
    return _F.conv2d(x, weight, bias, stride, padding, dilation, groups)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias``, weight (out, in)."""
    return _F.linear(x, weight, bias)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def batch_norm_stats(x: torch.Tensor, axes: Sequence[int]
                     ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Per-channel (count, mean, biased var) over ``axes``, in fp32 from
    one pass over x (mean and mean of squares)."""
    axes = tuple(axes)
    x32 = x.float()
    n = math.prod(x.shape[a] for a in axes)
    mean = x32.mean(dim=axes)
    mean_sq = torch.square(x32).mean(dim=axes)
    var = torch.clamp_min(mean_sq - torch.square(mean), 0.0)
    return n, mean, var


def batch_norm_apply(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], eps: float,
                     channel_axis: int = 1) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * weight + bias`` per channel.  NCHW
    input goes through the fused op: the JAX package's ``pallas_forced()``
    branch (nn/functional.py:250-258 there), which eager PyTorch needs on
    the main path since nothing fuses the torch ops below."""
    if x.dim() == 4 and channel_axis == 1:
        C = x.shape[1]
        f32 = dict(dtype=torch.float32, device=x.device)
        w = weight if weight is not None else torch.ones(C, **f32)
        b = bias if bias is not None else torch.zeros(C, **f32)
        return ops.batch_norm_apply_fused(x, mean, var, w, b, float(eps))
    shape = [1] * x.dim()
    shape[channel_axis] = x.shape[channel_axis]
    inv = torch.rsqrt(var.float() + eps)
    scale = inv if weight is None else inv * weight.float()
    shift = -mean.float() * scale
    if bias is not None:
        shift = shift + bias.float()
    y = x.float() * scale.view(shape) + shift.view(shape)
    return y.to(x.dtype)


def max_pool2d(x: torch.Tensor, kernel_size, stride=None, padding=0
               ) -> torch.Tensor:
    """NCHW max pool; padding counts as -inf, as in the JAX package."""
    return _F.max_pool2d(x, kernel_size, stride, padding)


def adaptive_avg_pool2d(x: torch.Tensor, output_size=1) -> torch.Tensor:
    """Global average pool (output_size 1 only, as in the JAX package),
    summed in fp32 and cast back."""
    if output_size not in (1, (1, 1)):
        raise NotImplementedError("adaptive_avg_pool2d supports output_size=1")
    return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  reduction: str = "mean") -> torch.Tensor:
    """Softmax cross entropy computed in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh form by default, erf when not
    ``approximate``."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]``."""
    return _F.embedding(ids.long(), table)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)`` in x's dtype, as the JAX package does; the mask comes
    from ``generator`` (on x's device)."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=dim)
