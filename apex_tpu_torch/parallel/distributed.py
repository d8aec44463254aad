"""DistributedDataParallel on ``torch.distributed``: the flat data-parallel
core of ``apex_tpu/parallel/distributed.py``.

``DistributedDataParallel`` wraps an ``nn.Module``.  At construction it
broadcasts rank 0's parameters (through the amp optimizer's fp32 masters
when the model went through ``amp.initialize``, then the half copy is
re-derived from them).  At the end of every backward (an autograd
callback queued by the first parameter hook that fires) it all-reduces the
grads in buckets with the JAX package's contents and options:

- buckets split by grad dtype, the leaves in the JAX package's leaf order
  (``amp.jax_leaf_order`` of the parameter names), and split again after
  each ``allreduce_trigger_params`` parameter;
- ``allreduce_always_fp32`` upcasts a half bucket for the collective;
- ``gradient_predivide_factor`` divides before the collective and
  ``gradient_average`` by ``world / factor`` after it
  (:func:`predivide_factors`: the mean is taken once);
- a bucket longer than ``message_size`` goes out in ``message_size``
  chunks, unless ``delay_allreduce`` or trigger parameters set its bounds;
- ``retain_allreduce_buffers`` keeps the reduced flat buckets in
  ``allreduce_buffers``, and ``last_comm_stats`` records each bucket.

The grads all-reduced are the ones ``backward`` left in ``.grad``: under
``amp.scale_loss`` the scaled grads, reduced before amp unscales them into
its stash, as the JAX package's step all-reduces ``amp.scaled_grad``'s
output before ``optimizer.step``.

The JAX package's hierarchical topology, ``adasum``, the overlapped and
staged schedules, ZeRO stage 2 and the numerics out-parameters are not
ported: passing one raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..amp._process_optimizer import jax_leaf_order

__all__ = ["DistributedDataParallel", "Reducer", "predivide_factors",
           "flat_dist_call", "ReduceOp"]

_UNPORTED = ("is not ported yet (ROADMAP queue 1 item 12, the wider "
             "parallel stack)")


class ReduceOp:
    """The reduction names :func:`flat_dist_call` takes (the JAX package's
    shim of ``torch.distributed.ReduceOp``)."""
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    MEAN = "mean"


def predivide_factors(world, gradient_predivide_factor: float = 1.0):
    """The pre/post division split (distributed.py:86-100 of the JAX
    package): grads are divided by ``pre`` before the collective and by
    ``post`` after it under ``gradient_average``, ``pre * post == world``,
    so the mean is taken exactly once."""
    f = float(gradient_predivide_factor)
    if f == 1.0:
        return 1.0, world
    return f, world / f


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _require_initialized(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what} needs torch.distributed: call "
                           f"apex_tpu_torch.parallel.init_process_group() "
                           f"first")


def _dtype_groups(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype,
                                                          List[int]]:
    """Indices by dtype, each dtype in order of its first leaf (the JAX
    package's ``groups`` dict)."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _broadcast0(flat: torch.Tensor, group) -> None:
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast(flat, src, group=group)


def flat_dist_call(tensors: Sequence[torch.Tensor], op: str = "sum",
                   group=None) -> List[torch.Tensor]:
    """One collective per dtype group over the flattened tensors, written
    back in place (apply_flat_dist_call; distributed.py:1009-1028 of the
    JAX package).  ``op``: ``"sum"``, ``"max"``, ``"min"``, ``"mean"`` or
    ``"broadcast"`` (every rank gets the group's first rank's values)."""
    _require_initialized("flat_dist_call")
    reduce_ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                  "min": dist.ReduceOp.MIN, "mean": dist.ReduceOp.SUM}
    if op not in reduce_ops and op != "broadcast":
        raise ValueError(f"op must be one of {sorted(reduce_ops)} or "
                         f"'broadcast', got {op!r}")
    tensors = list(tensors)
    for idxs in _dtype_groups(tensors).values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idxs])
        if op == "broadcast":
            _broadcast0(flat, group)
        else:
            dist.all_reduce(flat, op=reduce_ops[op], group=group)
            if op == "mean":
                world = float(dist.get_world_size(group))
                flat = flat / torch.full((), world, dtype=flat.dtype,
                                         device=flat.device)
        off = 0
        for i in idxs:
            n = tensors[i].numel()
            with torch.no_grad():
                tensors[i].copy_(flat[off:off + n].view(tensors[i].shape))
            off += n
    return tensors


def _bucket_accounting(n: int, comm_dtype: torch.dtype, message_size: int,
                       delay_allreduce: bool, triggered: bool
                       ) -> Dict[str, Any]:
    """Why a bucket flushed and in how many collectives: the flat branch of
    the JAX package's ``_bucket_wire_accounting``.  The chunks here are
    slices of the bucket, so nothing is padded."""
    if delay_allreduce or triggered or n <= message_size:
        cause = ("trigger" if triggered
                 else "delay" if delay_allreduce else "single")
        chunks = 1
    else:
        cause = "chunked"
        chunks = math.ceil(n / message_size)
    return {"cause": cause, "chunks": chunks,
            "bytes": n * comm_dtype.itemsize}


class DistributedDataParallel(torch.nn.Module):
    """Model wrapper with the reference's constructor surface; see the
    module doc.  ``process_group`` takes the place of the JAX package's
    ``axis_name`` (``None``: the world)."""

    def __init__(self, module: torch.nn.Module,
                 message_size: int = 10_000_000,
                 delay_allreduce: bool = False,
                 shared_param: Optional[bool] = None,
                 allreduce_trigger_params: Optional[Sequence[str]] = None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 process_group=None, *, adasum: bool = False,
                 comm_topology: str = "flat",
                 allreduce_compress_bf16: bool = False,
                 ici_size: Optional[int] = None, overlap: bool = False,
                 zero_stage: Optional[int] = None):
        super().__init__()
        if shared_param is not None:
            raise ValueError("shared_param is deprecated (reference "
                             "distributed.py:176-180)")
        for name, unported in (("adasum", adasum),
                               ("comm_topology != 'flat'",
                                comm_topology != "flat"),
                               ("allreduce_compress_bf16",
                                allreduce_compress_bf16),
                               ("ici_size", ici_size is not None),
                               ("overlap", overlap),
                               ("zero_stage", zero_stage is not None)):
            if unported:
                raise NotImplementedError(f"DistributedDataParallel "
                                          f"{name} {_UNPORTED}")
        _require_initialized("DistributedDataParallel")
        self.module = module
        self.message_size = int(message_size)
        self.delay_allreduce = bool(delay_allreduce)
        self.retain_allreduce_buffers = bool(retain_allreduce_buffers)
        self.allreduce_always_fp32 = bool(allreduce_always_fp32)
        self.gradient_average = bool(gradient_average)
        self.gradient_predivide_factor = float(gradient_predivide_factor)
        self.process_group = process_group
        self.allreduce_buffers: List[torch.Tensor] = []
        self.last_comm_stats: List[Dict[str, Any]] = []

        by_name = dict(module.named_parameters())
        self._names = jax_leaf_order(by_name)
        self._params = [by_name[n] for n in self._names]
        self._triggers = self._trigger_indices(allreduce_trigger_params)
        self._queued = False
        self.broadcast_params()
        # the hook lives in the param's C++ grad accumulator, where the
        # garbage collector cannot see it: a strong reference to self
        # would keep this wrapper, its module and the module's optimizer
        # alive for the life of the process
        ready = weakref.WeakMethod(self._grad_ready)

        def hook(param):
            fn = ready()
            if fn is not None:
                fn(param)

        for p in self._params:
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(hook)

    def _trigger_indices(self, triggers) -> Optional[set]:
        """Leaf indices of the trigger parameters, given by name (dotted,
        as ``named_parameters`` gives them)."""
        if not triggers:
            return None
        index = {n: i for i, n in enumerate(self._names)}
        unknown = sorted(set(triggers) - set(index))
        if unknown:
            raise ValueError(f"allreduce_trigger_params not found among the "
                             f"module's parameters: {unknown}; available: "
                             f"{self._names[:8]}...")
        return {index[t] for t in triggers}

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    # -- construction-time broadcast -------------------------------------------
    def broadcast_params(self) -> None:
        """Every rank takes rank 0's parameters (reference distributed.py:
        234).  After ``amp.initialize`` the fp32 masters are broadcast and
        the half copy re-derived from them, so masters and half params
        agree on every rank."""
        opt = getattr(self.module, "_amp_optimizer", None)
        if opt is not None:
            opt.refresh_masters()
            flat = opt.masters.buf.clone()
            _broadcast0(flat, self.process_group)
            layout = opt.masters.layout
            opt.write_masters(dict(zip(layout.names, layout.pieces(flat))))
        else:
            flat_dist_call(self._params, "broadcast", self.process_group)

    # -- the end-of-backward all-reduce ----------------------------------------
    def _grad_ready(self, _param) -> None:
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._after_backward)

    def _after_backward(self) -> None:
        self._queued = False
        self.allreduce_grads()

    def _buckets(self, idxs: List[int]) -> List[List[int]]:
        if not self._triggers:
            return [idxs]
        buckets, cur = [], []
        for i in idxs:
            cur.append(i)
            if i in self._triggers:
                buckets.append(cur)
                cur = []
        if cur:
            buckets.append(cur)
        return buckets

    def allreduce_grads(self) -> None:
        """All-reduce the module's ``.grad``s in place, in buckets (see
        the module doc).  A parameter without a grad contributes zeros and
        keeps ``grad = None``."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        world = dist.get_world_size(self.process_group)
        pre, _ = predivide_factors(world, self.gradient_predivide_factor)
        # world / pre in fp32, as the JAX package divides its fp32 axis size
        post = float(np.float32(world) / np.float32(pre))
        stats, retained = [], []
        for dt, idxs in _dtype_groups(grads).items():
            for bucket in self._buckets(idxs):
                flat = torch.cat([grads[i].reshape(-1) for i in bucket])
                comm = flat.float() if self.allreduce_always_fp32 else flat
                if pre != 1.0:
                    comm = comm / torch.full((), pre, dtype=comm.dtype,
                                             device=comm.device)
                n = comm.numel()
                acct = _bucket_accounting(n, comm.dtype, self.message_size,
                                          self.delay_allreduce,
                                          bool(self._triggers))
                step = n if acct["chunks"] == 1 else self.message_size
                for k in range(acct["chunks"]):
                    dist.all_reduce(comm[k * step:(k + 1) * step],
                                    group=self.process_group)
                if self.gradient_average:
                    comm = comm / torch.full((), post, dtype=comm.dtype,
                                             device=comm.device)
                reduced = comm.to(dt)
                stats.append({"dtype": _dtype_name(dt),
                              "comm_dtype": _dtype_name(comm.dtype),
                              "leaves": len(bucket), "elements": n, **acct})
                retained.append(reduced)
                off = 0
                with torch.no_grad():
                    for i in bucket:
                        p, k = self._params[i], grads[i].numel()
                        if p.grad is not None:
                            p.grad.copy_(reduced[off:off + k].view(p.shape))
                        off += k
        self.last_comm_stats = stats
        self.allreduce_buffers = retained if self.retain_allreduce_buffers \
            else []


class Reducer:
    """Manual all-reduce helper (reference distributed.py:89-126; the JAX
    package's :1589-1616): ``reduce()`` sums, and averages, the grads of
    ``module_or_tensors``'s parameters (or the given tensors) over the
    group, in place; construction broadcasts rank 0's parameters."""

    def __init__(self, module_or_tensors, gradient_average: bool = True,
                 process_group=None):
        _require_initialized("Reducer")
        self.module = module_or_tensors
        self.gradient_average = gradient_average
        self.process_group = process_group
        if isinstance(module_or_tensors, torch.nn.Module):
            self.broadcast_params()

    def _tensors(self) -> List[torch.Tensor]:
        if isinstance(self.module, torch.nn.Module):
            return [p.grad for p in self.module.parameters()
                    if p.grad is not None]
        return list(self.module)

    def reduce(self, tensors: Optional[Sequence[torch.Tensor]] = None
               ) -> List[torch.Tensor]:
        tensors = list(tensors) if tensors is not None else self._tensors()
        op = "mean" if self.gradient_average else "sum"
        return flat_dist_call(tensors, op, self.process_group)

    def broadcast_params(self) -> None:
        params = (list(self.module.parameters())
                  if isinstance(self.module, torch.nn.Module)
                  else list(self.module))
        flat_dist_call(params, "broadcast", self.process_group)
