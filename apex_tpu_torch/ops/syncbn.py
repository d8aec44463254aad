"""Kernel wrappers for the BatchNorm apply on NCHW, forward and backward,
each beside its plain PyTorch version, and the autograd op built on them.

Counterpart of ``apex_tpu/ops/pallas_syncbn.py``; the kernels are
``csrc/syncbn.cu``.  ``batch_norm_apply_fused(x, mean, var, w, b, eps)``
has the JAX custom VJP's contract: it treats (x, mean, var, w, b) as
independent inputs and returns local gradients, and autograd through the
statistics (torch ops, and SyncBatchNorm's differentiable all-reduce)
supplies the rest, as ``jax.grad`` does in the JAX package.

- ``syncbn_fwd``: ``y = ((x - mean_c) * inv_c) * w_c + b_c`` in fp32, cast
  to x's dtype.
- ``syncbn_bwd``: ``dx = (dy * w_c) * inv_c`` in dy's dtype, and per
  (n, c) row the fp32 sums of dy and of dy * xhat, ``xhat = (x - mean_c) *
  inv_c``, as (N, C) tensors.

``inv = rsqrt(var + eps)`` is formed outside the kernels by torch, as the
JAX wrapper forms it outside its kernels.  x and dy are fp32, bf16 or
fp16; the per-channel vectors are fp32.  A wrapper given CUDA tensors
launches its kernel and adds one to its ``launches`` count; given CPU
tensors it runs the plain version; anything else raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, _launches

__all__ = ["syncbn_fwd", "syncbn_bwd", "batch_norm_apply_fused"]

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT_MAX = 2 ** 31 - 1


def _per_channel(x: torch.Tensor, **vecs: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _KIND:
        raise TypeError(f"x must be float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NCHW)")
    for name, v in vecs.items():
        _build.require(v, name, torch.float32, x.shape[1], align=1)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


# -- forward -----------------------------------------------------------------

def _fwd_plain(x, mean, inv, w, b):
    y = ((x.float() - _col(mean)) * _col(inv)) * _col(w) + _col(b)
    return y.to(x.dtype)


def syncbn_fwd(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
               w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The normalize-and-affine pass over NCHW ``x`` (see module doc)."""
    _per_channel(x, mean=mean, inv=inv, w=w, b=b)
    if not _build.use_kernel(x, mean, inv, w, b):
        return _fwd_plain(x, mean, inv, w, b)
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        N, C, H, W = x.shape
        lib = _build.library("syncbn")
        _build.check(lib.apex_bn_fwd(
            x.data_ptr(), y.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            w.data_ptr(), b.data_ptr(), n, H * W, C, _KIND[x.dtype],
            _build.stream_ptr(x)), "apex_bn_fwd")
        _launches.count(syncbn_fwd)
    return y


syncbn_fwd.launches = 0


# -- backward ----------------------------------------------------------------

def _bwd_plain(dy, x, mean, inv, w):
    d = dy.float()
    dx = ((d * _col(w)) * _col(inv)).to(dy.dtype)
    xhat = (x.float() - _col(mean)) * _col(inv)
    return dx, d.sum(dim=(2, 3)), (d * xhat).sum(dim=(2, 3))


def syncbn_bwd(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
               inv: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, sum_dy, sum_dy_xhat)``: dx like dy, the two sums (N, C) in
    fp32, one per (n, c) row (see module doc)."""
    _per_channel(x, mean=mean, inv=inv, w=w)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous with x's shape and dtype, "
                         f"got {tuple(dy.shape)} {dy.dtype} against "
                         f"{tuple(x.shape)} {x.dtype}")
    if not _build.use_kernel(dy, x, mean, inv, w):
        return _bwd_plain(dy, x, mean, inv, w)
    N, C, H, W = x.shape
    if N * C > _INT_MAX:
        raise ValueError(f"N*C = {N * C} rows exceed the kernel's int index")
    dx = torch.empty_like(dy)
    sums = torch.empty((2, N, C), dtype=torch.float32, device=x.device)
    if dy.numel():
        lib = _build.library("syncbn")
        _build.check(lib.apex_bn_bwd(
            dy.data_ptr(), x.data_ptr(), dx.data_ptr(), mean.data_ptr(),
            inv.data_ptr(), w.data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr(), N * C, H * W, C, _KIND[x.dtype],
            _build.stream_ptr(x)), "apex_bn_bwd")
        _launches.count(syncbn_bwd)
    else:
        sums.zero_()
    return dx, sums[0], sums[1]


syncbn_bwd.launches = 0


# -- the autograd op -------------------------------------------------------------

class _BatchNormApply(torch.autograd.Function):
    """pallas_syncbn.py:142-163: the kernels forward and backward, then the
    per-channel sum over N and the epilogue in torch."""

    @staticmethod
    def forward(ctx, x, mean, var, w, b, eps):
        x = x.contiguous()
        m32 = mean.float().contiguous()
        inv = torch.rsqrt(var.float() + eps).contiguous()
        w32 = w.float().contiguous()
        y = syncbn_fwd(x, m32, inv, w32, b.float().contiguous())
        ctx.save_for_backward(x, m32, inv, w32)
        ctx.dtypes = (mean.dtype, var.dtype, w.dtype, b.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, m32, inv, w32 = ctx.saved_tensors
        dx, sdy, sdyx = syncbn_bwd(dy.contiguous(), x, m32, inv, w32)
        sum_dy = sdy.sum(dim=0)
        sum_dy_xhat = sdyx.sum(dim=0)
        md, vd, wd, bd = ctx.dtypes
        dmean = (-w32 * inv * sum_dy).to(md)
        dvar = (-0.5 * w32 * inv * inv * sum_dy_xhat).to(vd)
        return (dx, dmean, dvar, sum_dy_xhat.to(wd), sum_dy.to(bd), None)


def batch_norm_apply_fused(x: torch.Tensor, mean: torch.Tensor,
                           var: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, eps: float) -> torch.Tensor:
    """``y = (x - mean_c) * rsqrt(var_c + eps) * w_c + b_c`` on NCHW, with
    the backward of the JAX package's custom VJP."""
    return _BatchNormApply.apply(x, mean, var, w, b, float(eps))
