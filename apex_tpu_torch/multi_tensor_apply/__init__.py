"""Multi-tensor ops and flat buffers (see ``multi_tensor`` and
``flatten``), and the reference's ``multi_tensor_applier`` shim."""

from .flatten import (ChunkedFlat, ChunkedFlatLayout, TreeFlattener, flatten,
                      pack_flat, split_by_dtype, unflatten, unpack_flat)
from .multi_tensor import (global_grad_norm, multi_tensor_axpby,
                           multi_tensor_l2norm, multi_tensor_scale)

__all__ = ["pack_flat", "unpack_flat", "flatten", "unflatten",
           "split_by_dtype", "TreeFlattener", "ChunkedFlatLayout",
           "ChunkedFlat", "multi_tensor_scale", "multi_tensor_axpby",
           "multi_tensor_l2norm", "global_grad_norm", "MultiTensorApply",
           "multi_tensor_applier"]


class MultiTensorApply:
    """The reference's ``MultiTensorApply`` (the JAX package's shim):
    ``applier(op, tensor_lists, *args)`` calls ``op(*tensor_lists, *args)``
    and returns what it returns, ``(outputs, found_inf)`` for the ops of
    this package, where the reference mutates a noop-flag buffer.
    ``chunk_size`` is kept for the signature: the kernels pick their own
    grid."""

    available = True
    warned = False

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, tensor_lists, *args, **kwargs):
        return op(*tensor_lists, *args, **kwargs)


multi_tensor_applier = MultiTensorApply(2048 * 32)
