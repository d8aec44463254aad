"""Attention: the dispatch between the flash kernels and the dense path.

Counterpart of ``apex_tpu/transformer/attention.py``.  The dispatch is the
JAX package's, with one change: where JAX asks ``use_pallas_for(q)`` and
``fits_vmem``, the port takes the flash route whenever the mask is None or
key-padding shaped, q, k and v have one shape, and that shape is within
the kernels' limits (``ops.flash_attention.fits``: head dim 1 to 128, int
indices).  On a CUDA tensor that route runs the flash kernels; on a CPU
tensor their plain versions (never the dense path).  The kernels stream
K/V, so sequence length needs no gate.  Arbitrary per-pair masks and
shapes past the kernels' limits take the dense path, plain torch ops as
in JAX, on either device.

Dropout.  Where the JAX package reads the apply context's train flag and
rng, the port's caller decides: attention dropout runs when
``dropout_rate > 0`` and a ``generator`` is given (modules pass theirs in
train mode only).  The flash route draws its two int32 seed words from
that generator on the device; the dense route draws its mask from it, so
the two routes agree in distribution, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import nn
from ..nn import functional as F
from ..ops import flash_attention as fa

__all__ = ["dot_product_attention", "MultiheadAttention", "set_path_hook"]

# which path each call took ("flash" or "dense"), for parity harnesses
_path_hook = None


def set_path_hook(hook) -> None:
    """Install ``hook(path: str)``, called on every dispatch (None clears)."""
    global _path_hook
    _path_hook = hook


def _note_path(path: str) -> None:
    if _path_hook is not None:
        _path_hook(path)


def _draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """Two int32 seed words for the flash kernels' dropout hash, drawn on
    ``device`` from ``generator``: no host round trip."""
    return torch.randint(0, 2 ** 31 - 1, (2,), dtype=torch.int32,
                         device=device, generator=generator)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          dropout_rate: float = 0.0, causal: bool = False,
                          generator: Optional[torch.Generator] = None,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q, k, v: (..., T, D); softmax(q k^T * scale) v with an fp32 softmax.
    ``mask`` True = attend; a (B, 1, 1, Tk) mask (key padding) stays on the
    flash route.  ``segment_ids``: (B, T) packed-sequence ids.  A query
    whose keys are all masked gives zeros on the flash route and a uniform
    average on the dense route, as in JAX."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if segment_ids is not None:
        if q.dim() != 4:
            raise ValueError("segment_ids requires (B, H, T, D) operands")
        expect = (q.shape[0], k.shape[-2])
        if tuple(segment_ids.shape) != expect:
            raise ValueError(f"segment_ids must be (B, T) = {expect}, got "
                             f"{tuple(segment_ids.shape)}")
    train_dropout = dropout_rate > 0.0 and generator is not None
    B = q.shape[0] if q.dim() == 4 else None
    Tk = k.shape[-2]
    kv_mask = None
    if (mask is not None and q.dim() == 4 and mask.dim() == 4
            and mask.shape[-2] == 1 and mask.shape[1] == 1
            and mask.shape[0] in (1, B) and mask.shape[-1] == Tk):
        kv_mask = (mask[:, 0, 0, :] != 0).expand(B, Tk)
    if ((mask is None or kv_mask is not None) and q.dim() == 4
            and q.shape == k.shape == v.shape and fa.fits(q.shape)):
        _note_path("flash")
        return fa.flash_attention(
            q, k, v, causal=causal, scale=scale, kv_mask=kv_mask,
            dropout_rate=dropout_rate if train_dropout else 0.0,
            dropout_seed=(_draw_seed(generator, q.device) if train_dropout
                          else None),
            segment_ids=segment_ids)
    _note_path("dense")
    if causal:
        Tq = q.shape[-2]
        # the last query attends to the whole key sequence; a user mask
        # ANDs with the causal one
        qpos = Tk - Tq + torch.arange(Tq, device=q.device)
        cmask = qpos[:, None] >= torch.arange(Tk, device=q.device)[None, :]
        mask = cmask if mask is None else torch.logical_and(mask, cmask)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if mask is not None:
        scores = torch.where(mask.bool(), scores, -1e30)
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        scores = torch.where(seg, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if train_dropout:
        probs = F.dropout(probs, dropout_rate, generator)
    return torch.matmul(probs.to(v.dtype), v)


class MultiheadAttention(torch.nn.Module):
    """Self-attention: one (E, 3E) projection, heads of E / num_heads,
    the output projection, and dropout on the output in train mode."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = True, *, device=None,
                 generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"num_heads ({num_heads}) must divide "
                             f"embed_dim ({embed_dim})")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        kw = dict(device=device, generator=generator)
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim, bias=bias, **kw)
        self.out = nn.Linear(embed_dim, embed_dim, bias=bias, **kw)
        self.drop = nn.Dropout(dropout, generator=dropout_generator)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None):
        """``key_padding_mask``: (B, T) bool, True = IGNORE that key
        (torch.nn.MultiheadAttention's convention), routed as a (B, 1, 1,
        T) validity mask that the flash route streams."""
        B, T, E = x.shape
        qkv = self.qkv(x).reshape(B, T, 3, self.num_heads, self.head_dim)
        q, k, v = (qkv[:, :, i].movedim(2, 1) for i in range(3))
        if key_padding_mask is not None:
            kp = torch.logical_not(key_padding_mask)[:, None, None, :]
            mask = kp if mask is None else torch.logical_and(mask, kp)
        ctx = dot_product_attention(q, k, v, mask)
        ctx = ctx.movedim(1, 2).reshape(B, T, E)
        return self.out(self.drop(ctx))
