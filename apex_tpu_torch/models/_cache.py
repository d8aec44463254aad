"""KV-cache writes shared by the GPT and Llama decode paths.

Counterpart of ``apex_tpu/models/_cache.py``.  A cache is a dict of
static per-layer buffers, ``{"k", "v"}`` (B, Hkv, S, D), plus ``{"k_scale",
"v_scale"}`` (B, Hkv, S, 1) fp32 when the buffers are int8.  Every write
goes through :func:`write` (or :func:`seed_layer` for a whole buffer),
and every int8 write quantizes through :func:`quantize_kv`, so a chunked
prefill is interchangeable with stepping the prompt token by token.  The
port writes in place (``index_copy_``) where the JAX package returns new
arrays: the buffers keep their addresses, as a captured decode step
will need.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["seed_layer", "quantize_kv", "write", "read"]


def quantize_kv(val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE int8 KV quantization: per-position symmetric amax/127 over the
    head dim, fp32 scales.  Returns (int8 values, fp32 scales)."""
    f = val.float()
    amax = f.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor, as quantization.quantize divides (the card's
    # division by a Python scalar multiplies by its reciprocal)
    scale = torch.div(amax.clamp_min(1e-12), torch.full_like(amax, 127.0))
    return torch.round(f / scale).clamp(-127, 127).to(torch.int8), scale


def _put(buf: torch.Tensor, val: torch.Tensor, pos) -> None:
    """Write ``val`` (B, Hkv, L, X) into ``buf`` at positions ``pos`` (an
    int or 0-d tensor: the same for every row) or ``pos`` (B,) (per row),
    ``[pos, pos + L)`` along axis 2, in place."""
    L = val.shape[2]
    val = val.to(buf.dtype)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        B = buf.shape[0]
        rows = torch.arange(B, device=buf.device)[:, None].expand(B, L)
        slots = pos.long()[:, None] + torch.arange(L, device=buf.device)
        # an index_put_ through the (B, S, Hkv, X) view writes buf itself
        buf.transpose(1, 2)[rows, slots] = val.transpose(1, 2)
        return
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1).long() + torch.arange(L, device=buf.device)
    else:
        idx = torch.arange(pos, pos + L, device=buf.device)
    buf.index_copy_(2, idx, val)


def write(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
          pos) -> None:
    """Write k, v (B, Hkv, L, D) into one layer's ``cache`` at ``pos``
    (see :func:`_put`), quantizing when the buffers are int8."""
    if cache["k"].dtype == torch.int8:
        for name, val in (("k", k), ("v", v)):
            ints, scale = quantize_kv(val)
            _put(cache[name], ints, pos)
            _put(cache[f"{name}_scale"], scale, pos)
    else:
        _put(cache["k"], k, pos)
        _put(cache["v"], v, pos)


def read(cache: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The layer's whole K and V as fp32 (int8 entries times their
    scales)."""
    if cache["k"].dtype == torch.int8:
        return (cache["k"].float() * cache["k_scale"].float(),
                cache["v"].float() * cache["v_scale"].float())
    return cache["k"].float(), cache["v"].float()


def seed_layer(layer_cache: Dict[str, torch.Tensor], k: torch.Tensor,
               v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write k/v (B, Hkv, T, D) at positions [0, T) of one layer's cache
    (T == the buffer length S for a full-buffer prefill), in place;
    returns the layer's dict."""
    write(layer_cache, k, v, 0)
    return layer_cache
