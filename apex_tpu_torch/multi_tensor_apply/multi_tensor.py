"""Multi-tensor ops over a flat fp32 buffer or a list of tensors.

Counterpart of ``apex_tpu/multi_tensor_apply/multi_tensor.py``.  Where
the JAX package picks the Pallas kernel or its jnp path by backend
(``ops/dispatch.py``), the port picks by the tensor's device inside each
kernel wrapper of :mod:`apex_tpu_torch.ops`: CUDA launches the kernel,
the CPU runs its plain PyTorch version.

A single 1-D fp32 tensor goes to the kernel as it is.  A list is packed
into one fp32 buffer first and the results are unpacked to the input
dtypes (the JAX package's pytree form).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .. import ops
from .flatten import ChunkedFlatLayout, pack_flat, unpack_flat

__all__ = ["multi_tensor_scale", "multi_tensor_axpby", "multi_tensor_l2norm",
           "global_grad_norm"]

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _is_flat(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.dim() == 1
            and x.dtype == torch.float32)


def _flat(x: Tensors) -> torch.Tensor:
    return x if _is_flat(x) else pack_flat(
        [x] if isinstance(x, torch.Tensor) else x, torch.float32)


def _back(flat: torch.Tensor, like: Tensors):
    if _is_flat(like):
        return flat
    if isinstance(like, torch.Tensor):
        return unpack_flat(flat, [like])[0]
    return unpack_flat(flat, list(like))


def multi_tensor_scale(x: Tensors, scale) -> Tuple[Tensors, torch.Tensor]:
    """``out = x * scale``; found_inf flags a non-finite *input*."""
    out, found = ops.multi_tensor_scale(_flat(x), scale)
    return _back(out, x), found


def multi_tensor_axpby(a, b, x: Tensors, y: Tensors, arg_to_check: int = -1
                       ) -> Tuple[Tensors, torch.Tensor]:
    """``out = a*x + b*y``; finite check on x (0), y (1) or both (-1)."""
    out, found = ops.multi_tensor_axpby(a, b, _flat(x), _flat(y),
                                        arg_to_check)
    return _back(out, x), found


def multi_tensor_l2norm(x: Tensors, per_tensor: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Global fp32 L2 norm, and with ``per_tensor`` the norm of each
    tensor of the list (a non-float one taken as fp32, so the result stays
    aligned with the list) through the per-tensor l2norm kernel."""
    if not per_tensor:
        return ops.multi_tensor_l2norm(_flat(x)), None
    tensors = [t.float() for t in
               ([x] if isinstance(x, torch.Tensor) else x)]
    if not tensors:
        return torch.zeros(()), torch.zeros(0)
    lay = ChunkedFlatLayout(tensors)
    sq = lay.per_tensor_sqsum(lay.pack(tensors))
    return torch.sqrt(torch.sum(sq)), torch.sqrt(sq)


def global_grad_norm(x: Tensors) -> torch.Tensor:
    """fp32 global L2 norm, -1.0 when it is not finite (the overflow
    convention of the JAX package's ``global_grad_norm``)."""
    norm, _ = multi_tensor_l2norm(x)
    return torch.where(torch.isfinite(norm), norm, -torch.ones_like(norm))
