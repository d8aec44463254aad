"""The layer library, as ``torch.nn.Module``s.

Counterpart of ``apex_tpu/nn/layers.py``, with its class names and
defaults.  ``Conv2d``, ``ConvTranspose2d`` and the pools take the JAX
package's ``data_format`` ("NCHW" or "NHWC"); weights stay OIHW (I, O,
kH, kW for the transposed convolution) in both.
Parameters are made on the CPU from an explicit ``torch.Generator``
(uniform in +-sqrt(1/fan_in), as the JAX package draws them; N(0,
``init_std``) for ``Embedding``) and moved to ``device``.  ``Dropout``
draws its masks from an explicit generator on the activations' device
and is active in train mode (``module.training``), where the JAX package
asks its apply context.  Lists of layers are ``torch.nn.ModuleList``,
whose children are named ``0``, ``1``, ... as the JAX package's are.
``BatchNorm2d`` sets ``fp32_params = True``: amp keeps its parameters
fp32 under ``keep_batchnorm_fp32``.  Its running statistics
follow the JAX package: momentum 0.1, unbiased running variance, an int32
``num_batches_tracked``; ``affine``, ``track_running_stats`` and
``channel_axis`` are the JAX module's options.  ``LayerNorm`` is the
JAX module over the LayerNorm kernels (``normalization.FusedLayerNorm``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..amp import policy as _policy
from ..normalization import FusedLayerNorm
from . import functional as F

__all__ = [
    "Linear", "Conv2d", "ConvTranspose2d", "BatchNorm2d", "LayerNorm",
    "Embedding", "Dropout", "ReLU", "LeakyReLU", "GELU", "Tanh", "Sigmoid",
    "Identity", "Flatten", "MaxPool2d", "AvgPool2d", "AdaptiveAvgPool2d",
]


def _uniform(shape, fan_in: int, generator: torch.Generator,
             device) -> torch.nn.Parameter:
    bound = math.sqrt(1.0 / fan_in)
    w = torch.empty(shape, dtype=torch.float32)
    w.uniform_(-bound, bound, generator=generator)
    return torch.nn.Parameter(w.to(device))


class Conv2d(torch.nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]], stride=1,
                 padding=0, dilation=1, groups: int = 1, bias: bool = True,
                 data_format: str = "NCHW", *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        fan_in = (in_channels // groups) * kernel_size[0] * kernel_size[1]
        self.weight = _uniform(
            (out_channels, in_channels // groups, *kernel_size), fan_in,
            generator, device)
        self.bias = (_uniform((out_channels,), fan_in, generator, device)
                     if bias else None)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class ConvTranspose2d(torch.nn.Module):
    """Transposed convolution, weight (in, out, kH, kW); its fan-in is
    torch's, from ``weight.size(1)`` (out_channels), as the JAX
    package's."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]], stride=1,
                 padding=0, output_padding=0, bias: bool = True,
                 data_format: str = "NCHW", *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.data_format = data_format
        fan_in = out_channels * kernel_size[0] * kernel_size[1]
        self.weight = _uniform((in_channels, out_channels, *kernel_size),
                               fan_in, generator, device)
        self.bias = (_uniform((out_channels,), fan_in, generator, device)
                     if bias else None)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.data_format)


class Linear(torch.nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device=None, generator: torch.Generator):
        super().__init__()
        self.weight = _uniform((out_features, in_features), in_features,
                               generator, device)
        self.bias = (_uniform((out_features,), in_features, generator, device)
                     if bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BatchNorm2d(torch.nn.Module):
    """Batch norm over every axis but ``channel_axis`` (1 for NCHW, -1 for
    channels-last), with running statistics as buffers.  ``_sync_stats``
    is the hook SyncBatchNorm overrides to combine the statistics across
    ranks; here it returns its input."""

    fp32_params = True

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, channel_axis: int = 1, *,
                 device=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.channel_axis = channel_axis
        f32 = dict(dtype=torch.float32, device=device)
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(num_features, **f32))
            self.bias = torch.nn.Parameter(torch.zeros(num_features, **f32))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        if track_running_stats:
            self.register_buffer("running_mean",
                                 torch.zeros(num_features, **f32))
            self.register_buffer("running_var",
                                 torch.ones(num_features, **f32))
            self.register_buffer("num_batches_tracked", torch.zeros(
                (), dtype=torch.int32, device=device))
        else:
            self.register_buffer("running_mean", None)
            self.register_buffer("running_var", None)
            self.register_buffer("num_batches_tracked", None)

    def _sync_stats(self, count, mean, var):
        return count, mean, var

    def forward(self, x):
        if self.training or not self.track_running_stats:
            ca = self.channel_axis % x.dim()
            axes = tuple(a for a in range(x.dim()) if a != ca)
            count, mean, var = F.batch_norm_stats(x, axes)
            count, mean, var = self._sync_stats(count, mean, var)
            if self.training and self.track_running_stats:
                self._update_running_stats(count, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return F.batch_norm_apply(x, mean, var, self.weight, self.bias,
                                  self.eps, channel_axis=self.channel_axis)

    @torch.no_grad()
    def _update_running_stats(self, count, mean, var):
        m = self.momentum
        if isinstance(count, torch.Tensor):
            # a synced count: count/(count-1) formed in fp32 on the device,
            # as the JAX package forms it, so no step waits on the host
            c = count.float()
            factor = c / torch.clamp_min(c - 1.0, 1.0)
        else:
            # count/(count-1) rounded in fp32, as the JAX package forms it
            # from fp32 arrays
            c = np.float32(count)
            factor = float(c / max(c - np.float32(1), np.float32(1)))
        unbiased = var.detach() * factor
        self.running_mean.copy_(
            (1 - m) * self.running_mean + m * mean.detach())
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        self.num_batches_tracked.add_(1)


class MaxPool2d(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.data_format)


class AvgPool2d(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.data_format)


class AdaptiveAvgPool2d(torch.nn.Module):
    def __init__(self, output_size=1, data_format: str = "NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class ReLU(torch.nn.Module):
    def forward(self, x):
        return F.relu(x)


class LeakyReLU(torch.nn.Module):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class GELU(torch.nn.Module):
    """``F.gelu``'s default, the tanh form, as the JAX package's."""

    def forward(self, x):
        return F.gelu(x)


class Tanh(torch.nn.Module):
    def forward(self, x):
        return F.tanh(x)


class Sigmoid(torch.nn.Module):
    def forward(self, x):
        return F.sigmoid(x)


class Identity(torch.nn.Module):
    def forward(self, x):
        return x


class Flatten(torch.nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Embedding(torch.nn.Module):
    """Rows of a (num_embeddings, embedding_dim) table, N(0, init_std)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 init_std: float = 1.0, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        w = torch.empty((num_embeddings, embedding_dim), dtype=torch.float32)
        w.normal_(0.0, init_std, generator=generator)
        self.weight = torch.nn.Parameter(w.to(device))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Dropout(torch.nn.Module):
    """Inverted dropout in train mode; ``generator`` (on the activations'
    device) draws the masks."""

    def __init__(self, rate: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        return F.dropout(x, self.rate, self.generator)


class LayerNorm(FusedLayerNorm):
    """``nn.LayerNorm`` of the JAX package: weight ones and bias zeros,
    kept fp32 by amp, normalized by the LayerNorm kernels; the output has
    the input's dtype.  The JAX layer goes through ``F.layer_norm``, a
    blacklist op, so under O1 its input is cast to fp32: this one casts
    through the policy's "layer_norm" entry, then runs the kernels
    (``FusedLayerNorm`` itself consults no policy, as the JAX one)."""

    def forward(self, x):
        (x,), _ = _policy.cast_op_args("layer_norm", (x,), {})
        return super().forward(x)
