"""Flat buffers over lists of tensors.

Counterpart of ``pack_flat``/``unpack_flat`` in
``apex_tpu/multi_tensor_apply/flatten.py``: the kernels run over one
contiguous buffer instead of a list of tensors.  (``ChunkedFlatLayout``,
for per-tensor norms, is not ported yet.)
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

__all__ = ["pack_flat", "unpack_flat"]


def pack_flat(tensors: Sequence[torch.Tensor],
              dtype: Optional[torch.dtype] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate the raveled tensors into one 1-D buffer, cast to
    ``dtype`` (default: the first tensor's) — written into ``out`` when
    given.  An empty list gives a 0-length buffer."""
    tensors = list(tensors)
    if dtype is None:
        dtype = out.dtype if out is not None else (
            tensors[0].dtype if tensors else torch.float32)
    if not tensors:
        return torch.zeros((0,), dtype=dtype) if out is None else out
    parts = [t.reshape(-1) for t in tensors]
    if out is None:
        return torch.cat([p.to(dtype) for p in parts])
    # cat promotes mixed input dtypes and casts into ``out``: one launch
    return torch.cat(parts, out=out)


def unpack_flat(flat: torch.Tensor, like: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Inverse of :func:`pack_flat`: pieces of ``flat`` shaped and typed
    like ``like`` (views when no cast is needed)."""
    out, off = [], 0
    for t in like:
        n = t.numel()
        piece = flat[off:off + n].view(t.shape)
        if piece.dtype != t.dtype:
            piece = piece.to(t.dtype)
        out.append(piece)
        off += n
    return out
