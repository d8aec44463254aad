"""Flat buffers over lists of tensors.

Counterpart of ``apex_tpu/multi_tensor_apply/flatten.py``: the kernels
run over one contiguous buffer instead of a list of tensors.  Where the
JAX package flattens a pytree, the port takes a list of tensors in the
order the caller gives (``amp`` gives the JAX package's leaf order).

``ChunkedFlatLayout`` keeps the JAX names and API, with one difference:
its buffer is dense (each tensor right after the previous one), where the
JAX package pads every tensor to a multiple of ``chunk``.  Its chunk
table (``ops.ChunkTable``) carries the tensor boundaries instead, which is
what the per-tensor kernels read, so the amp masters, whose layout is
dense, need no second copy.  ``utils.jax_interop`` maps the JAX package's
padded buffers onto it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import ops

__all__ = ["pack_flat", "unpack_flat", "flatten", "unflatten",
           "split_by_dtype", "TreeFlattener", "ChunkedFlatLayout",
           "ChunkedFlat"]


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


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate raveled same-dtype tensors into one 1-D buffer."""
    tensors = list(tensors)
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError("flatten() requires a same-dtype tensor list; "
                        "use split_by_dtype first")
    return pack_flat(tensors)


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Inverse of :func:`flatten`: views of ``flat`` shaped like ``like``."""
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def split_by_dtype(tensors: Sequence[torch.Tensor]
                   ) -> Dict[torch.dtype, List[Tuple[int, torch.Tensor]]]:
    """Group (index, tensor) pairs by dtype, keeping the order within a
    group (the reference's split_half_float_double)."""
    groups: Dict[torch.dtype, List[Tuple[int, torch.Tensor]]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append((i, t))
    return groups


class TreeFlattener:
    """One flat buffer per dtype group of a tensor list, and back; the
    shapes and groups are fixed at construction."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.shapes = [tuple(t.shape) for t in tensors]
        self.groups = {dt: [i for i, _ in pairs]
                       for dt, pairs in split_by_dtype(tensors).items()}

    def pack(self, tensors: Sequence[torch.Tensor]
             ) -> Dict[torch.dtype, torch.Tensor]:
        return {dt: pack_flat([tensors[i] for i in idxs])
                for dt, idxs in self.groups.items()}

    def unpack(self, buffers: Dict[torch.dtype, torch.Tensor]
               ) -> List[torch.Tensor]:
        out: List[Optional[torch.Tensor]] = [None] * len(self.shapes)
        for dt, idxs in self.groups.items():
            off = 0
            for i in idxs:
                n = math.prod(self.shapes[i])
                out[i] = buffers[dt][off:off + n].view(self.shapes[i])
                off += n
        return out


class ChunkedFlatLayout:
    """Layout of the float tensors of a list in one dense flat buffer,
    with the chunk table of its per-tensor reductions (see the module doc).

    Non-float tensors take no room (size 0) and are not counted in
    ``num_tensors``; ``unpack`` hands them back from ``like``.  The chunk
    table, (tensor id, start, length <= ``chunk``) rows, is built once per
    device."""

    def __init__(self, tensors: Sequence[torch.Tensor], chunk: int = 1024):
        self.chunk = int(chunk)
        self.shapes = tuple(tuple(t.shape) for t in tensors)
        self.dtypes = tuple(t.dtype for t in tensors)
        self.is_float = tuple(t.is_floating_point() for t in tensors)
        sizes, offsets, off = [], [], 0
        for shape, f in zip(self.shapes, self.is_float):
            n = math.prod(shape) if f else 0
            sizes.append(n)
            offsets.append(off)
            off += n
        self.sizes = tuple(sizes)
        self.offsets = tuple(offsets)
        self.total = off
        self.num_tensors = sum(self.is_float)
        self._tables: Dict[torch.device, ops.ChunkTable] = {}

    def spans(self) -> List[Tuple[int, int]]:
        """(offset, length) of each float tensor."""
        return [(o, n) for o, n, f in zip(self.offsets, self.sizes,
                                           self.is_float) if f]

    def chunk_table(self, device) -> ops.ChunkTable:
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = ops.ChunkTable.build(
                self.spans(), self.chunk, device)
        return self._tables[device]

    def pack(self, tensors: Sequence[torch.Tensor],
             dtype: torch.dtype = torch.float32,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The float tensors, in layout order, as one flat buffer."""
        parts = [t for t, f in zip(tensors, self.is_float) if f]
        return pack_flat(parts, dtype, out=out)

    def unpack(self, flat: torch.Tensor,
               like: Optional[Sequence[torch.Tensor]] = None,
               cast_like: bool = True) -> List[Optional[torch.Tensor]]:
        """Per-tensor pieces of ``flat`` (views unless cast to the layout's
        dtypes); a non-float tensor comes from ``like`` (or is None)."""
        out = []
        for i, (shape, f) in enumerate(zip(self.shapes, self.is_float)):
            if not f:
                out.append(like[i] if like is not None else None)
                continue
            piece = flat[self.offsets[i]:self.offsets[i] + self.sizes[i]]
            piece = piece.view(shape)
            out.append(piece.to(self.dtypes[i]) if cast_like else piece)
        return out

    def per_tensor_sqsum(self, flat: torch.Tensor) -> torch.Tensor:
        """(num_tensors,) fp32 sum of squares of each tensor (the
        per-tensor l2norm kernel on the card)."""
        return ops.multi_tensor_l2norm_per_tensor(
            flat, self.chunk_table(flat.device))

    def expand_per_tensor(self, vals: torch.Tensor) -> torch.Tensor:
        """(num_tensors,) -> (total,): each tensor's value over its
        elements, through the chunk table (no host sync)."""
        t = self.chunk_table(vals.device)
        return torch.repeat_interleave(vals[t.chunks[:, 0]], t.chunks[:, 2],
                                       output_size=self.total)


@dataclass
class ChunkedFlat:
    """A flat buffer and its layout (the JAX package's pytree node)."""
    buf: torch.Tensor
    layout: ChunkedFlatLayout
