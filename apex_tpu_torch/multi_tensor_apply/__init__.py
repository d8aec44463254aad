"""Multi-tensor ops and flat buffers (see ``multi_tensor`` and ``flatten``)."""

from .flatten import (ChunkedFlat, ChunkedFlatLayout, TreeFlattener, flatten,
                      pack_flat, split_by_dtype, unflatten, unpack_flat)
from .multi_tensor import (global_grad_norm, multi_tensor_axpby,
                           multi_tensor_l2norm, multi_tensor_scale)

__all__ = ["pack_flat", "unpack_flat", "flatten", "unflatten",
           "split_by_dtype", "TreeFlattener", "ChunkedFlatLayout",
           "ChunkedFlat", "multi_tensor_scale", "multi_tensor_axpby",
           "multi_tensor_l2norm", "global_grad_norm"]
