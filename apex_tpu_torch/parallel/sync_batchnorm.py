"""SyncBatchNorm: batch norm whose training statistics are combined across
the ranks of a ``torch.distributed`` group.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py``.  Each rank's local
(count, mean, biased var) are merged with Chan's combine in one all-reduce
of (count, count*mean, var*count + count*mean^2); then
``g_mean = sum_x / total`` and ``g_var = max(sum_x2 / total - g_mean^2,
0)``.  The all-reduce is differentiable: its backward all-reduces the
cotangent (a sum), which is ``psum``'s transpose, so the gradient through
the statistics reaches every rank's inputs as ``jax.grad`` of the JAX
package's ``psum`` does.  The apply is ``BatchNorm2d``'s (the syncbn
kernels on NCHW).

Without an initialized ``torch.distributed`` the statistics stay local: the
counterpart of the JAX package's unmapped-axis branch.  In a group of one
rank the all-reduce still runs, as ``psum`` does under ``shard_map`` on one
device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..nn.layers import BatchNorm2d

__all__ = ["SyncBatchNorm"]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group, differentiable: the gradient is
    all-reduced too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class SyncBatchNorm(BatchNorm2d):
    """Drop-in ``BatchNorm2d`` whose training statistics are synchronized
    over ``process_group`` (a ``torch.distributed`` group, as
    ``create_syncbn_process_group`` returns; ``None`` is the world).
    ``channel_last`` takes NHWC input (``channel_axis`` -1, else 1)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 process_group: Optional[object] = None,
                 channel_last: bool = False, *, device=None):
        super().__init__(num_features, eps=eps, momentum=momentum,
                         affine=affine,
                         track_running_stats=track_running_stats,
                         channel_axis=-1 if channel_last else 1,
                         device=device)
        self.process_group = process_group

    def _sync_stats(self, count, mean, var):
        if not (dist.is_available() and dist.is_initialized()):
            return count, mean, var
        c = (count.reshape(1).float() if isinstance(count, torch.Tensor)
             else torch.full((1,), float(count), dtype=torch.float32,
                             device=mean.device))
        m2 = var * c + c * torch.square(mean)
        packed = torch.cat([c, mean * c, m2])
        total, sum_x, sum_x2 = torch.split(
            _AllReduceSum.apply(packed, self.process_group),
            [1, mean.numel(), mean.numel()])
        total = total.reshape(())
        g_mean = sum_x / total
        # E[x^2] - mean^2 can round below 0 for |mean| >> std
        g_var = torch.clamp_min(sum_x2 / total - torch.square(g_mean), 0.0)
        return total, g_mean, g_var
