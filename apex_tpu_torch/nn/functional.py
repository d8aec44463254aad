"""Policy-aware functional ops, with the JAX package's numerics.

Counterpart of ``apex_tpu/nn/functional.py``.  Every op the O1 tables of
``amp.lists`` name funnels through :func:`op`, which hands its arguments to
``amp.policy.cast_op_args`` under the op's name: under O1 (a
``CastPolicy``) whitelist ops cast their floating args to the half dtype,
blacklist ops to fp32, promote ops to the widest floating dtype among
them; with no policy (O0/O2/O3) an op costs one policy lookup and runs in
its inputs' dtypes.  ``relu``, ``tanh``, ``embedding``, ``dropout``, the
pools, ``batch_norm_stats``/``batch_norm_apply`` and the other
unclassified ops are not wrapped, as in the JAX package.  Argument names
(``axis``, ``keepdims``) are the JAX package's.

Convolution and linear are ``torch.nn.functional`` calls (the JAX package
leaves them to XLA, outside any Pallas kernel).  Batch norm follows the JAX
formula: single-pass fp32 statistics E[x^2] - mean^2 clamped at 0, in
torch ops, then the apply in fp32 cast back to the input dtype.  On NCHW
input the apply is ``ops.batch_norm_apply_fused`` (the syncbn kernels on
the card, their plain versions on the CPU); any other layout keeps
``y = x*scale + shift`` in torch ops.  cuDNN's ``F.batch_norm`` is not
used: its Welford statistics round differently.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as _F

from .. import ops
from ..amp import policy as _policy

__all__ = [
    "linear", "matmul", "conv2d", "conv_transpose2d", "relu", "leaky_relu",
    "gelu", "gelu_exact", "silu", "sigmoid", "tanh",
    "softmax", "log_softmax", "layer_norm", "batch_norm_stats",
    "batch_norm_apply", "dropout", "max_pool2d", "avg_pool2d",
    "adaptive_avg_pool2d", "embedding", "space_to_depth",
    "cross_entropy", "nll_loss",
    "mse_loss", "l1_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "cat", "stack", "add", "mul",
]


def op(name: str):
    """Route a function through the active amp cast policy."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            args, kwargs = _policy.cast_op_args(name, args, kwargs)
            return fn(*args, **kwargs)
        wrapper.__amp_op__ = name
        return wrapper
    return deco


def _dims(x: torch.Tensor, axis) -> Tuple[int, ...]:
    """``axis`` as torch's ``dim``: every axis when None."""
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _bias_nd(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if bias is None:
        return y
    return y + bias.to(y.dtype).view((1, -1) + (1,) * (y.dim() - 2))


# ---------------------------------------------------------------------------
# whitelist (tensor-core) ops
# ---------------------------------------------------------------------------

@op("linear")
def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias``, weight (out, in)."""
    return _F.linear(x, weight, bias)


@op("matmul")
def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


@op("conv2d")
def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """NCHW convolution with OIHW weights."""
    return _F.conv2d(x, weight, bias, stride, padding, dilation, groups)


@op("conv_transpose2d")
def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride=1,
                     padding=0, output_padding=0) -> torch.Tensor:
    """NCHW transposed convolution; weight (I, O, kH, kW) like torch."""
    return _bias_nd(_F.conv_transpose2d(x, weight, None, stride, padding,
                                        output_padding), bias)


# ---------------------------------------------------------------------------
# pointwise / activations
# ---------------------------------------------------------------------------

def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01
               ) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


@op("gelu")
def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh form by default, erf when not
    ``approximate``."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-form gelu (HF BERT's 'gelu'); rides gelu's cast policy."""
    return gelu(x, approximate=False)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


# ---------------------------------------------------------------------------
# blacklist (fp32) ops
# ---------------------------------------------------------------------------

@op("softmax")
def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


@op("log_softmax")
def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


@op("layer_norm")
def layer_norm(x: torch.Tensor, normalized_shape: Sequence[int],
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5
               ) -> torch.Tensor:
    """Layer norm in fp32 with a two-pass variance, cast back to x's
    dtype (the JAX package's formula; ``normalization.FusedLayerNorm`` is
    the kernel's)."""
    axes = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    x32 = x.float()
    mean_ = x32.mean(dim=axes, keepdim=True)
    var_ = torch.square(x32 - mean_).mean(dim=axes, keepdim=True)
    y = (x32 - mean_) * torch.rsqrt(var_ + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def batch_norm_stats(x: torch.Tensor, axes: Sequence[int]
                     ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Per-channel (count, mean, biased var) over ``axes``, in fp32 from
    one pass over x (mean and mean of squares)."""
    axes = tuple(axes)
    x32 = x.float()
    n = math.prod(x.shape[a] for a in axes)
    mean_ = x32.mean(dim=axes)
    mean_sq = torch.square(x32).mean(dim=axes)
    var_ = torch.clamp_min(mean_sq - torch.square(mean_), 0.0)
    return n, mean_, var_


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


# ---------------------------------------------------------------------------
# dropout / pooling / embedding
# ---------------------------------------------------------------------------

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


def max_pool2d(x: torch.Tensor, kernel_size, stride=None, padding=0
               ) -> torch.Tensor:
    """NCHW max pool; padding counts as -inf, as in the JAX package."""
    return _F.max_pool2d(x, kernel_size, stride, padding)


def avg_pool2d(x: torch.Tensor, kernel_size, stride=None, padding=0
               ) -> torch.Tensor:
    """NCHW average pool; zero padding counts in the denominator, as in
    the JAX package."""
    return _F.avg_pool2d(x, kernel_size, stride, padding,
                         count_include_pad=True)


def adaptive_avg_pool2d(x: torch.Tensor, output_size=1) -> torch.Tensor:
    """Global average pool (output_size 1 only, as in the JAX package),
    summed in fp32 and cast back."""
    if output_size not in (1, (1, 1)):
        raise NotImplementedError("adaptive_avg_pool2d supports output_size=1")
    return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]``."""
    return _F.embedding(ids.long(), table)


def space_to_depth(x: torch.Tensor, block_size: int = 2,
                   data_format: str = "NCHW") -> torch.Tensor:
    """Rearrange ``block_size x block_size`` spatial tiles into channels:
    (B, C, H, W) -> (B, b*b*C, H/b, W/b), channel ``a*(b*C) + bb*C + c``
    for tile offset (a, bb); the same logical order in NHWC."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, "
                         f"got {data_format!r}")
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if data_format == "NCHW":
        B, C, H, W = x.shape
    else:
        B, H, W, C = x.shape
    if H % b or W % b:
        raise ValueError(f"spatial dims {(H, W)} not divisible by "
                         f"block_size {b}")
    if data_format == "NCHW":
        x = x.reshape(B, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(B, b * b * C, H // b, W // b)
    x = x.reshape(B, H // b, b, W // b, b, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // b, W // b, b * b * C)


# ---------------------------------------------------------------------------
# losses (blacklist: computed in fp32)
# ---------------------------------------------------------------------------

def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def _pick(t: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, -1, labels.long().unsqueeze(-1)).squeeze(-1)


@op("cross_entropy")
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  reduction: str = "mean") -> torch.Tensor:
    """Softmax cross entropy computed in fp32."""
    return _reduce(-_pick(torch.log_softmax(logits.float(), dim=-1),
                          labels), reduction)


@op("nll_loss")
def nll_loss(logp: torch.Tensor, labels: torch.Tensor,
             reduction: str = "mean") -> torch.Tensor:
    return _reduce(-_pick(logp, labels), reduction)


@op("mse_loss")
def mse_loss(x: torch.Tensor, y: torch.Tensor,
             reduction: str = "mean") -> torch.Tensor:
    return _reduce(torch.square(x - y), reduction)


@op("l1_loss")
def l1_loss(x: torch.Tensor, y: torch.Tensor,
            reduction: str = "mean") -> torch.Tensor:
    return _reduce(torch.abs(x - y), reduction)


@op("binary_cross_entropy")
def binary_cross_entropy(p: torch.Tensor, y: torch.Tensor,
                         reduction: str = "mean") -> torch.Tensor:
    # Reachable only when no policy is active or casts are disabled: under
    # an O1 policy this op name is banned (lists.BANNED_FUNCS) and raises.
    eps = 1e-12
    loss = -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))
    return _reduce(loss, reduction)


@op("binary_cross_entropy_with_logits")
def binary_cross_entropy_with_logits(logits: torch.Tensor, y: torch.Tensor,
                                     reduction: str = "mean"
                                     ) -> torch.Tensor:
    z = logits.float()
    loss = (torch.clamp_min(z, 0) - z * y
            + torch.log1p(torch.exp(-torch.abs(z))))
    return _reduce(loss, reduction)


# ---------------------------------------------------------------------------
# promote / sequence ops
# ---------------------------------------------------------------------------

@op("cat")
def cat(tensors: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    return torch.cat(list(tensors), dim=axis)


@op("stack")
def stack(tensors: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    return torch.stack(list(tensors), dim=axis)


@op("add")
def add(a, b):
    return a + b


@op("mul")
def mul(a, b):
    return a * b


# ---------------------------------------------------------------------------
# The rest of the amp.lists surface: every name the O1 tables classify is a
# policy-aware op here, as in the JAX package.
# ---------------------------------------------------------------------------

# -- whitelist: gemm family (torch_overrides.py:7-27) -------------------------

@op("mm")
def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


@op("mv")
def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, v)


@op("bmm")
def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


@op("addmm")
def addmm(c, a, b, *, beta: float = 1.0, alpha: float = 1.0):
    return beta * c + alpha * torch.matmul(a, b)


@op("addmv")
def addmv(c, a, v, *, beta: float = 1.0, alpha: float = 1.0):
    return beta * c + alpha * torch.matmul(a, v)


@op("addr")
def addr(c, u, v, *, beta: float = 1.0, alpha: float = 1.0):
    return beta * c + alpha * torch.outer(u, v)


@op("addbmm")
def addbmm(c, a, b, *, beta: float = 1.0, alpha: float = 1.0):
    return beta * c + alpha * torch.matmul(a, b).sum(dim=0)


@op("baddbmm")
def baddbmm(c, a, b, *, beta: float = 1.0, alpha: float = 1.0):
    return beta * c + alpha * torch.matmul(a, b)


@op("prelu")
def prelu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    w = (weight.reshape((1, -1) + (1,) * (x.dim() - 2)) if x.dim() > 1
         else weight)
    return torch.where(x >= 0, x, w.to(x.dtype) * x)


# -- whitelist: conv family ------------------------------------------------------

@op("conv1d")
def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """NCW conv; weight (O, I/groups, kW) like torch."""
    return _bias_nd(_F.conv1d(x, weight, None, stride, padding, dilation,
                              groups), bias)


@op("conv3d")
def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """NCDHW conv; weight (O, I/groups, kD, kH, kW) like torch."""
    return _bias_nd(_F.conv3d(x, weight, None, stride, padding, dilation,
                              groups), bias)


@op("conv_transpose1d")
def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride=1,
                     padding=0) -> torch.Tensor:
    """NCW transposed conv; weight (I, O, kW) like torch."""
    return _bias_nd(_F.conv_transpose1d(x, weight, None, stride, padding),
                    bias)


@op("conv_transpose3d")
def conv_transpose3d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride=1,
                     padding=0) -> torch.Tensor:
    """NCDHW transposed conv; weight (I, O, kD, kH, kW) like torch."""
    return _bias_nd(_F.conv_transpose3d(x, weight, None, stride, padding),
                    bias)


@op("conv_tbc")
def conv_tbc(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor], pad: int = 0) -> torch.Tensor:
    """Time x Batch x Channels conv (torch.conv_tbc): x (T, B, Cin),
    weight (kW, Cin, Cout)."""
    y = _F.conv1d(x.permute(1, 2, 0), weight.permute(2, 1, 0), None, 1, pad)
    y = y.permute(2, 0, 1)                            # (T', B, Cout)
    return y if bias is None else y + bias.to(y.dtype)


# -- blacklist: pointwise transcendentals ----------------------------------------

def _fp32_unary(name, fn):
    @op(name)
    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        return fn(x, *args, **kwargs)
    wrapper.__name__ = name
    wrapper.__qualname__ = name
    return wrapper


def _cumulative(fn):
    def run(x, axis=None):
        # jnp's default: over the flattened array
        return fn(x.reshape(-1), dim=0) if axis is None else fn(x, dim=axis)
    return run


exp = _fp32_unary("exp", torch.exp)
expm1 = _fp32_unary("expm1", torch.expm1)
log = _fp32_unary("log", torch.log)
log10 = _fp32_unary("log10", torch.log10)
log2 = _fp32_unary("log2", torch.log2)
log1p = _fp32_unary("log1p", torch.log1p)
reciprocal = _fp32_unary("reciprocal", torch.reciprocal)
rsqrt = _fp32_unary("rsqrt", torch.rsqrt)
acos = _fp32_unary("acos", torch.acos)
asin = _fp32_unary("asin", torch.asin)
cosh = _fp32_unary("cosh", torch.cosh)
sinh = _fp32_unary("sinh", torch.sinh)
tan = _fp32_unary("tan", torch.tan)
erf = _fp32_unary("erf", torch.erf)
erfinv = _fp32_unary("erfinv", torch.erfinv)
cumsum = _fp32_unary("cumsum", _cumulative(torch.cumsum))
cumprod = _fp32_unary("cumprod", _cumulative(torch.cumprod))


@op("pow")
def pow(x: torch.Tensor, exponent) -> torch.Tensor:  # noqa: A001 (torch name)
    return torch.pow(x, exponent)


@op("softplus")
def softplus(x: torch.Tensor, beta: float = 1.0,
             threshold: float = 20.0) -> torch.Tensor:
    scaled = beta * x
    # the exp argument clamped: where() evaluates both branches, and an
    # overflowed exp would turn the dead branch's zero grad into NaN
    safe = torch.log1p(torch.exp(torch.clamp_max(scaled, threshold))) / beta
    return torch.where(scaled > threshold, x, safe)


# -- blacklist: reductions -------------------------------------------------------

@op("sum")
def sum(x, axis=None, keepdims: bool = False):  # noqa: A001 (torch name)
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims)


@op("mean")
def mean(x, axis=None, keepdims: bool = False):
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdims)


@op("prod")
def prod(x, axis=None, keepdims: bool = False):
    for d in sorted((a % x.dim() for a in _dims(x, axis)), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdims)
    return x


@op("std")
def std(x, axis=None, keepdims: bool = False):
    """Standard deviation with ddof 1, as the JAX package's."""
    return torch.std(x, dim=_dims(x, axis), correction=1, keepdim=keepdims)


@op("var")
def var(x, axis=None, keepdims: bool = False):
    """Variance with ddof 1, as the JAX package's."""
    return torch.var(x, dim=_dims(x, axis), correction=1, keepdim=keepdims)


@op("logsumexp")
def logsumexp(x, axis=None, keepdims: bool = False):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdims)


def _pnorm(x, p, dim, keepdim=False):
    if p == 2.0:
        return torch.sqrt(torch.sum(torch.square(x), dim=dim,
                                    keepdim=keepdim))
    return torch.sum(torch.abs(x) ** p, dim=dim, keepdim=keepdim) ** (1.0 / p)


@op("norm")
def norm(x, p: float = 2.0, axis=None, keepdims: bool = False):
    return _pnorm(x, p, _dims(x, axis), keepdims)


@op("dist")
def dist(a, b, p: float = 2.0):
    d = a - b
    return _pnorm(d, p, _dims(d, None))


@op("renorm")
def renorm(x, p: float, axis: int, maxnorm: float):
    """Per-slice (along ``axis``) p-norm clamp to maxnorm (torch.renorm)."""
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = _pnorm(flat, p, 1)
    factor = torch.where(norms > maxnorm, maxnorm / (norms + 1e-7), 1.0)
    return torch.movedim((flat * factor[:, None]).reshape(moved.shape),
                         0, axis)


@op("softmin")
def softmin(x, axis: int = -1):
    return torch.softmax(-x, dim=axis)


@op("normalize")
def normalize(x, p: float = 2.0, axis: int = 1, eps: float = 1e-12):
    return x / torch.clamp_min(_pnorm(x, p, axis, True), eps)


@op("cosine_similarity")
def cosine_similarity(a, b, axis: int = 1, eps: float = 1e-8):
    num = torch.sum(a * b, dim=axis)
    na = torch.sqrt(torch.sum(torch.square(a), dim=axis))
    nb = torch.sqrt(torch.sum(torch.square(b), dim=axis))
    return num / torch.clamp_min(na * nb, eps)


@op("pdist")
def pdist(x, p: float = 2.0):
    """Condensed pairwise distances of the rows of x (N, D)."""
    n = x.shape[0]
    diff = x[:, None, :] - x[None, :, :]
    if p == 2.0:
        d = torch.sqrt(torch.sum(torch.square(diff), dim=-1) + 1e-30)
    else:
        d = torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)
    iu, ju = torch.triu_indices(n, n, 1, device=x.device)
    return d[iu, ju]


# -- blacklist: norms ------------------------------------------------------------

def _affine(out, weight, bias):
    shape = (1, out.shape[1]) + (1,) * (out.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@op("group_norm")
def group_norm(x, num_groups: int, weight=None, bias=None,
               eps: float = 1e-5):
    N, C = x.shape[:2]
    g = x.reshape(N, num_groups, C // num_groups, *x.shape[2:])
    axes = tuple(range(2, g.dim()))
    mean_ = g.mean(dim=axes, keepdim=True)
    var_ = torch.square(g - mean_).mean(dim=axes, keepdim=True)
    return _affine(((g - mean_) * torch.rsqrt(var_ + eps)).reshape(x.shape),
                   weight, bias)


@op("instance_norm")
def instance_norm(x, weight=None, bias=None, eps: float = 1e-5):
    axes = tuple(range(2, x.dim()))
    mean_ = x.mean(dim=axes, keepdim=True)
    var_ = torch.square(x - mean_).mean(dim=axes, keepdim=True)
    return _affine((x - mean_) * torch.rsqrt(var_ + eps), weight, bias)


@op("batch_norm")
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.1,
               eps: float = 1e-5):
    """Stateless batch norm (the running statistics are inputs; their
    updates live in the BatchNorm modules)."""
    if training or running_mean is None:
        _, mean_, var_ = batch_norm_stats(
            x, (0,) + tuple(range(2, x.dim())))
    else:
        mean_, var_ = running_mean, running_var
    return batch_norm_apply(x, mean_, var_, weight, bias, eps)


# -- blacklist: losses -----------------------------------------------------------

@op("smooth_l1_loss")
def smooth_l1_loss(x, target, beta: float = 1.0, reduction: str = "mean"):
    d = torch.abs(x - target)
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _reduce(loss, reduction)


@op("kl_div")
def kl_div(log_pred, target, reduction: str = "mean",
           log_target: bool = False):
    if log_target:
        loss = torch.exp(target) * (target - log_pred)
    else:
        loss = torch.where(target > 0, target * (torch.log(
            torch.clamp_min(target, 1e-38)) - log_pred), 0.0)
    if reduction == "batchmean":
        return loss.sum() / log_pred.shape[0]
    return _reduce(loss, reduction)


@op("soft_margin_loss")
def soft_margin_loss(x, target, reduction: str = "mean"):
    return _reduce(torch.log1p(torch.exp(-target * x)), reduction)


@op("poisson_nll_loss")
def poisson_nll_loss(log_input, target, log_input_form: bool = True,
                     full: bool = False, eps: float = 1e-8,
                     reduction: str = "mean"):
    if log_input_form:
        loss = torch.exp(log_input) - target * log_input
    else:
        loss = log_input - target * torch.log(log_input + eps)
    if full:
        t1 = torch.clamp_min(target, 1.0)
        stirling = (target * torch.log(t1) - target
                    + 0.5 * torch.log(2 * math.pi * t1))
        loss = loss + torch.where(target > 1, stirling, 0.0)
    return _reduce(loss, reduction)


@op("cosine_embedding_loss")
def cosine_embedding_loss(a, b, target, margin: float = 0.0,
                          reduction: str = "mean"):
    cos = torch.sum(a * b, dim=-1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), 1e-8)
    loss = torch.where(target == 1, 1.0 - cos,
                       torch.clamp_min(cos - margin, 0.0))
    return _reduce(loss, reduction)


@op("hinge_embedding_loss")
def hinge_embedding_loss(x, target, margin: float = 1.0,
                         reduction: str = "mean"):
    loss = torch.where(target == 1, x, torch.clamp_min(margin - x, 0.0))
    return _reduce(loss, reduction)


@op("margin_ranking_loss")
def margin_ranking_loss(x1, x2, target, margin: float = 0.0,
                        reduction: str = "mean"):
    return _reduce(torch.clamp_min(-target * (x1 - x2) + margin, 0.0),
                   reduction)


@op("triplet_margin_loss")
def triplet_margin_loss(anchor, positive, negative, margin: float = 1.0,
                        p: float = 2.0, reduction: str = "mean"):
    dp = torch.sum(torch.abs(anchor - positive) ** p, dim=-1) ** (1.0 / p)
    dn = torch.sum(torch.abs(anchor - negative) ** p, dim=-1) ** (1.0 / p)
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


@op("multi_margin_loss")
def multi_margin_loss(x, target, p: float = 1.0, margin: float = 1.0,
                      reduction: str = "mean"):
    N, C = x.shape
    t = target.long()
    xy = torch.gather(x, 1, t[:, None])
    loss = torch.clamp_min(margin - xy + x, 0.0) ** p
    own = torch.arange(C, device=x.device)[None, :] == t[:, None]
    loss = torch.where(own, 0.0, loss)
    return _reduce(loss.sum(dim=1) / C, reduction)


@op("multilabel_margin_loss")
def multilabel_margin_loss(x, target, reduction: str = "mean"):
    """torch semantics: per sample, target holds class indices padded with
    -1 after the first -1; loss sums max(0, 1 - (x[y] - x[k])) over target
    classes y and non-target classes k, / C."""
    N, C = x.shape
    neg = target < 0
    count = torch.where(neg.any(dim=1), torch.argmax(neg.int(), dim=1), C)
    pos_mask = torch.arange(C, device=x.device)[None, :] < count[:, None]
    tgt = torch.where(pos_mask, target, 0).long()
    is_target = torch.zeros((N, C), dtype=torch.int64,
                            device=x.device).scatter_reduce(
        1, tgt, pos_mask.long(), reduce="amax") > 0
    xy = torch.gather(x, 1, tgt)                       # (N, C) target scores
    diff = 1.0 - (xy[:, :, None] - x[:, None, :])      # (N, C, C)
    valid = pos_mask[:, :, None] & ~is_target[:, None, :]
    loss = torch.where(valid, torch.clamp_min(diff, 0.0),
                       0.0).sum(dim=(1, 2)) / C
    return _reduce(loss, reduction)


# -- promote ops -----------------------------------------------------------------

@op("sub")
def sub(a, b):
    return a - b


@op("div")
def div(a, b):
    return a / b


@op("addcdiv")
def addcdiv(x, a, b, value: float = 1.0):
    return x + value * (a / b)


@op("addcmul")
def addcmul(x, a, b, value: float = 1.0):
    return x + value * (a * b)


@op("atan2")
def atan2(a, b):
    return torch.atan2(a, b)


@op("cross")
def cross(a, b, axis: int = -1):
    return torch.linalg.cross(a, b, dim=axis)


@op("dot")
def dot(a, b):
    """``jnp.dot`` for operands of at most two dims."""
    if a.dim() == b.dim() == 1:
        return torch.dot(a, b)
    return torch.matmul(a, b)


@op("bilinear")
def bilinear(x1, x2, weight, bias=None):
    """torch.nn.functional.bilinear: weight (out, in1, in2)."""
    y = torch.einsum("...i,oij,...j->...o", x1, weight, x2)
    return y if bias is None else y + bias


@op("eq")
def eq(a, b):
    return a == b


@op("ne")
def ne(a, b):
    return a != b


@op("lt")
def lt(a, b):
    return a < b


@op("gt")
def gt(a, b):
    return a > b


@op("le")
def le(a, b):
    return a <= b


@op("ge")
def ge(a, b):
    return a >= b


@op("equal")
def equal(a, b):
    """A 0-d bool tensor: same shape and every element equal."""
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return (a == b).all()


def _extremum(reduce, pairwise, a, b, axis, keepdims):
    if b is None:
        return reduce(a, dim=_dims(a, axis), keepdim=keepdims)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return pairwise(a, b)


@op("min")
def min(a, b=None, axis=None, keepdims: bool = False):  # noqa: A001
    return _extremum(torch.amin, torch.minimum, a, b, axis, keepdims)


@op("max")
def max(a, b=None, axis=None, keepdims: bool = False):  # noqa: A001
    return _extremum(torch.amax, torch.maximum, a, b, axis, keepdims)


@op("fmod")
def fmod(a, b):
    return torch.fmod(a, b)


@op("remainder")
def remainder(a, b):
    return torch.remainder(a, b)


@op("concatenate")
def concatenate(tensors: Sequence[torch.Tensor], axis: int = 0):
    return torch.cat(list(tensors), dim=axis)


__all__ += [
    "mm", "mv", "bmm", "addmm", "addmv", "addr", "addbmm", "baddbmm",
    "prelu", "conv1d", "conv3d", "conv_transpose1d", "conv_transpose3d",
    "conv_tbc",
    "exp", "expm1", "log", "log10", "log2", "log1p", "reciprocal", "rsqrt",
    "acos", "asin", "cosh", "sinh", "tan", "erf", "erfinv", "cumsum",
    "cumprod", "pow", "softplus",
    "sum", "mean", "prod", "std", "var", "logsumexp", "norm", "dist",
    "renorm", "softmin", "normalize", "cosine_similarity", "pdist",
    "group_norm", "instance_norm", "batch_norm",
    "smooth_l1_loss", "kl_div", "soft_margin_loss", "poisson_nll_loss",
    "cosine_embedding_loss", "hinge_embedding_loss", "margin_ranking_loss",
    "triplet_margin_loss", "multi_margin_loss", "multilabel_margin_loss",
    "sub", "div", "addcdiv", "addcmul", "atan2", "cross", "dot", "bilinear",
    "eq", "ne", "lt", "gt", "le", "ge", "equal", "min", "max", "fmod",
    "remainder", "concatenate",
]
