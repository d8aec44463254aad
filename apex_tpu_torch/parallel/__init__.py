"""Data parallelism and SyncBatchNorm on ``torch.distributed``.

Counterpart of the data-parallel core of ``apex_tpu/parallel``:
``DistributedDataParallel`` (bucketed grad all-reduce, on ``.grad`` at the
end of backward or on the functional step's grads, and ``make_step``, the
whole step captured in a CUDA graph), ``allreduce_comm_plan``, ``Reducer``,
``flat_dist_call``, ``SyncBatchNorm`` with ``convert_syncbn_model`` and
``create_syncbn_process_group``, ``LARC``, and ``init_process_group``
with the ``python -m apex_tpu_torch.parallel.multiproc`` launcher.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from . import multiproc
from .LARC import LARC
from .distributed import (DistributedDataParallel, Reducer, ReduceOp,
                          allreduce_comm_plan, flat_dist_call, make_step,
                          predivide_factors)
from .multiproc import init_process_group
from .sync_batchnorm import SyncBatchNorm

__all__ = ["DistributedDataParallel", "Reducer", "ReduceOp",
           "allreduce_comm_plan", "make_step", "flat_dist_call", "predivide_factors", "SyncBatchNorm",
           "convert_syncbn_model", "create_syncbn_process_group",
           "init_process_group", "multiproc", "LARC"]


def convert_syncbn_model(module: torch.nn.Module, process_group=None,
                         channel_last: bool = False) -> torch.nn.Module:
    """Replace every ``nn.BatchNorm2d`` in ``module`` with a
    ``SyncBatchNorm`` of the same options, parameters and buffers
    (reference parallel/__init__.py:21-53); ``channel_last``, or a layer
    whose channels are last, gives NHWC layers.  Returns the module, or the
    new layer when ``module`` itself is a BatchNorm2d.  Convert before
    ``amp.initialize``: after it the parameters are views into the
    optimizer's flat buffers, and a new layer would not be."""
    from ..nn.layers import BatchNorm2d

    if getattr(module, "_amp_initialized", False):
        raise RuntimeError("convert_syncbn_model must run before "
                           "amp.initialize: the parameters are views into "
                           "the optimizer's flat buffers after it")

    def convert(mod):
        if mod.channel_axis not in (1, -1, 3):
            raise ValueError(f"SyncBatchNorm takes channels first or last, "
                             f"not channel_axis {mod.channel_axis}")
        anchor = next(iter(mod.state_dict().values()), None)
        new = SyncBatchNorm(
            mod.num_features, eps=mod.eps, momentum=mod.momentum,
            affine=mod.affine, track_running_stats=mod.track_running_stats,
            process_group=process_group,
            channel_last=channel_last or mod.channel_axis in (-1, 3),
            device=None if anchor is None else anchor.device)
        new.load_state_dict(mod.state_dict())
        new.train(mod.training)
        return new

    if type(module) is BatchNorm2d:
        return convert(module)
    stack = [module]
    while stack:
        mod = stack.pop()
        for name, child in list(mod.named_children()):
            if type(child) is BatchNorm2d:
                setattr(mod, name, convert(child))
            else:
                stack.append(child)
    return module


def create_syncbn_process_group(group_size: int,
                                world_size: Optional[int] = None):
    """Split the world into groups of ``group_size`` consecutive ranks for
    grouped statistics (reference parallel/__init__.py:55-92) and return
    this rank's group, to pass as ``SyncBatchNorm(process_group=...)``.
    Every rank creates every group, as ``torch.distributed.new_group``
    requires.  ``group_size`` 0 or at least the world size: ``None``, the
    whole world."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("create_syncbn_process_group needs "
                           "torch.distributed: call init_process_group() "
                           "first")
    if world_size is None:
        world_size = dist.get_world_size()
    if group_size == 0 or group_size >= world_size:
        return None
    if world_size % group_size != 0:
        raise ValueError(f"world_size {world_size} must be divisible by "
                         f"group_size {group_size}")
    rank = dist.get_rank()
    mine = None
    for start in range(0, world_size, group_size):
        ranks = list(range(start, start + group_size))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine
