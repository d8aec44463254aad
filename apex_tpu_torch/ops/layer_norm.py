"""Kernel wrappers for LayerNorm over the rows of an (n1, n2) view, forward
and backward, each beside its plain PyTorch version.

Counterpart of ``apex_tpu/ops/pallas_layer_norm.py``; the kernels are
``csrc/layer_norm.cu``.  The contract is the JAX package's:

- ``layer_norm_fwd(x2, w, b, eps) -> (y, mean, inv)``: per row the mean,
  the shifted two-pass variance ``sum((x - mean)^2) / n2``, ``inv =
  rsqrt(var + eps)`` and ``y = ((x - mean) * inv) * w + b`` in fp32, y in
  x's dtype; mean and inv (n1,) fp32 even for half inputs.
- ``layer_norm_bwd(dy, x2, w, mean, inv) -> (dx, dw, db)``: ``dx = inv *
  ((g - mean(g)) - xhat * mean(g * xhat))`` with ``g = dy * w``, dx in x's
  dtype; ``dw = sum_rows(dy * xhat)`` and ``db = sum_rows(dy)`` in fp32.

``w`` and ``b`` are optional (ones and zeros, as the JAX wrapper pads
them).  x2 and dy are contiguous fp32, bf16 or fp16.  A wrapper given
CUDA tensors launches its kernel and adds one to its ``launches`` count;
given CPU tensors it runs the plain version; anything else raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["layer_norm_fwd", "layer_norm_bwd"]

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_WARPS = 8             # rows in flight per block (kWarps in the source)
_REG_COLS = 1024       # widest row kept in registers
_MAX_BWD_BLOCKS = 256  # the backward's partial rows of dw, db (n2 <= 1024)
_INT_MAX = 2 ** 31 - 1


def _rows(x2: torch.Tensor, name: str) -> None:
    if x2.dim() != 2:
        raise ValueError(f"{name} must be (n1, n2), got {tuple(x2.shape)}")
    if x2.dtype not in _KIND:
        raise TypeError(f"{name} must be float32, bfloat16 or float16, got "
                        f"{x2.dtype}")
    if not x2.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x2.numel() > _INT_MAX:
        raise ValueError(f"{name} has {x2.numel()} elements, more than the "
                         f"kernel's int index")


def _vec(v: Optional[torch.Tensor], n2: int, fill: float,
         like: torch.Tensor, name: str) -> torch.Tensor:
    if v is None:
        return torch.full((n2,), fill, dtype=torch.float32, device=like.device)
    _build.require(v, name, torch.float32, n2, align=1)
    return v


# -- forward -----------------------------------------------------------------

def _fwd_plain(x2, w, b, eps):
    x = x2.float()
    n2 = x.shape[1]
    mean = x.sum(dim=1, keepdim=True) / n2
    d = x - mean
    var = (d * d).sum(dim=1, keepdim=True) / n2
    inv = torch.rsqrt(var + eps)
    y = ((x - mean) * inv) * w + b
    return y.to(x2.dtype), mean[:, 0], inv[:, 0]


def layer_norm_fwd(x2: torch.Tensor, w: Optional[torch.Tensor],
                   b: Optional[torch.Tensor], eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, inv)`` of the rows of ``x2`` (see module doc)."""
    _rows(x2, "x2")
    n1, n2 = x2.shape
    w = _vec(w, n2, 1.0, x2, "w")
    b = _vec(b, n2, 0.0, x2, "b")
    if not _build.use_kernel(x2, w, b):
        return _fwd_plain(x2, w, b, eps)
    y = torch.empty_like(x2)
    mean = torch.empty(n1, dtype=torch.float32, device=x2.device)
    inv = torch.empty(n1, dtype=torch.float32, device=x2.device)
    if n1 and n2:
        lib = _build.library("layer_norm")
        _build.check(lib.apex_ln_fwd(
            x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), n1, n2, float(eps),
            _KIND[x2.dtype], _build.stream_ptr(x2)), "apex_ln_fwd")
        layer_norm_fwd.launches += 1
    return y, mean, inv


layer_norm_fwd.launches = 0


# -- backward ----------------------------------------------------------------

def _bwd_plain(dy, x2, w, mean, inv):
    n2 = x2.shape[1]
    d = dy.float()
    xhat = (x2.float() - mean[:, None]) * inv[:, None]
    g = d * w
    c1 = g.sum(dim=1, keepdim=True) / n2
    c2 = (g * xhat).sum(dim=1, keepdim=True) / n2
    dx = inv[:, None] * ((g - c1) - xhat * c2)
    return dx.to(x2.dtype), (d * xhat).sum(dim=0), d.sum(dim=0)


def layer_norm_bwd(dy: torch.Tensor, x2: torch.Tensor,
                   w: Optional[torch.Tensor], mean: torch.Tensor,
                   inv: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)``: dx like x2, dw and db (n2,) fp32 (module doc)."""
    _rows(x2, "x2")
    n1, n2 = x2.shape
    if dy.shape != x2.shape or dy.dtype != x2.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous with x2's shape and dtype, "
                         f"got {tuple(dy.shape)} {dy.dtype} against "
                         f"{tuple(x2.shape)} {x2.dtype}")
    w = _vec(w, n2, 1.0, x2, "w")
    _build.require(mean, "mean", torch.float32, n1, align=1)
    _build.require(inv, "inv", torch.float32, n1, align=1)
    if not _build.use_kernel(dy, x2, w, mean, inv):
        return _bwd_plain(dy, x2, w, mean, inv)
    dx = torch.empty_like(dy)
    f32 = dict(dtype=torch.float32, device=x2.device)
    if not (n1 and n2):
        return dx, torch.zeros(n2, **f32), torch.zeros(n2, **f32)
    blocks = min(-(-n1 // _WARPS), _MAX_BWD_BLOCKS)
    parts = blocks if n2 <= _REG_COLS else blocks * _WARPS
    part = torch.empty((2, parts, n2), **f32)
    grads = torch.empty((2, n2), **f32)
    lib = _build.library("layer_norm")
    _build.check(lib.apex_ln_bwd(
        dy.data_ptr(), x2.data_ptr(), w.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), dx.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        grads[0].data_ptr(), grads[1].data_ptr(), n1, n2, blocks,
        _KIND[x2.dtype], _build.stream_ptr(x2)), "apex_ln_bwd")
    layer_norm_bwd.launches += 1
    return dx, grads[0], grads[1]


layer_norm_bwd.launches = 0
