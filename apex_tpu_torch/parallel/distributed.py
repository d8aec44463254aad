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

The functional step (the JAX package's) passes its grads instead:
``allreduce_grads(grads)`` takes ``amp.scaled_grad``'s list (or a mapping
of parameter names) and returns the reduced grads, in the same buckets.
``torch.autograd.grad`` writes no ``.grad``, so the end-of-backward hook
does not fire on that step and nothing is reduced twice.
:func:`make_step` (``DistributedDataParallel.make_step``) turns such a
step into ``train(batch)``, captured in a CUDA graph on the card (the JAX
package's ``jax.jit`` over ``shard_map``), and :func:`allreduce_comm_plan`
gives the buckets' accounting from shapes alone.

The JAX package's hierarchical topology, ``adasum``, the overlapped and
staged schedules, ZeRO stage 2 and the numerics out-parameters are not
ported: passing one raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import _graph
from ..amp._process_optimizer import jax_leaf_order

__all__ = ["DistributedDataParallel", "Reducer", "predivide_factors",
           "flat_dist_call", "ReduceOp", "allreduce_comm_plan",
           "make_step"]

_UNPORTED = ("is not ported yet (ROADMAP queue 1 item 6, the wider "
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


def _dtype_groups(dtypes: Sequence[torch.dtype]) -> Dict[torch.dtype,
                                                        List[int]]:
    """Indices by dtype, each dtype in order of its first leaf (the JAX
    package's ``groups`` dict)."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, dt in enumerate(dtypes):
        groups.setdefault(dt, []).append(i)
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
    for idxs in _dtype_groups([t.dtype for t in tensors]).values():
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


def _bucket_wire_accounting(n: int, comm_dtype: torch.dtype,
                            message_size: int, delay_allreduce: bool,
                            triggered: bool) -> Dict[str, Any]:
    """Why a bucket flushed, in how many collectives and how many bytes go
    on the wire: the flat branch of the JAX package's
    ``_bucket_wire_accounting``, shared by the runtime's
    ``last_comm_stats`` and :func:`allreduce_comm_plan`, so the two cannot
    disagree.  A chunked bucket is padded to ``chunks * message_size``
    elements, as the JAX package pads it."""
    if delay_allreduce or triggered or n <= message_size:
        cause = ("trigger" if triggered
                 else "delay" if delay_allreduce else "single")
        chunks, wire = 1, n
    else:
        cause = "chunked"
        chunks = math.ceil(n / message_size)
        wire = chunks * message_size
    b = wire * comm_dtype.itemsize
    return {"cause": cause, "chunks": chunks, "topology": "flat",
            "wire_elements": wire, "padded_elements": wire - n,
            "bytes": b, "ici_wire_bytes": b, "dcn_wire_bytes": b,
            "dcn_comm_dtype": _dtype_name(comm_dtype),
            "eqns": {"psum": 1}, "eqn_payload_bytes": {"psum": b}}


def _plan_buckets(dtypes: Sequence[torch.dtype], trigger_idx: Optional[set]
                  ) -> List[List[int]]:
    """Leaf indices by bucket: split by dtype (each dtype in order of its
    first leaf), then after each trigger leaf."""
    out = []
    for idxs in _dtype_groups(dtypes).values():
        if not trigger_idx:
            out.append(idxs)
            continue
        cur: List[int] = []
        for i in idxs:
            cur.append(i)
            if i in trigger_idx:
                out.append(cur)
                cur = []
        if cur:
            out.append(cur)
    return out


def allreduce_comm_plan(grads: Any, message_size: int = 10_000_000,
                        allreduce_always_fp32: bool = False,
                        delay_allreduce: bool = False,
                        trigger_paths: Optional[set] = None,
                        comm_topology: str = "flat",
                        allreduce_compress_bf16: bool = False,
                        ici_size: Optional[int] = None,
                        world: Optional[int] = None,
                        nproc: Optional[int] = None) -> List[dict]:
    """The comm pattern one all-reduce of ``grads`` will have, from shapes
    alone (``apex_tpu/parallel/distributed.py:477``): one dict a bucket,
    ``{dtype, comm_dtype, leaves, elements, chunks, cause, topology,
    ici_size, dcn_size, wire_elements, padded_elements, wire_bytes,
    ici_wire_bytes, dcn_wire_bytes, dcn_comm_dtype, eqns,
    eqn_payload_bytes}``, the JAX package's dicts.

    ``grads``: a mapping of dotted parameter names to tensors (or anything
    with ``shape`` and ``dtype``), which are put in the JAX package's leaf
    order, or a list already in it.  ``trigger_paths`` names the trigger
    parameters.  Only the flat topology is ported; ``world`` and ``nproc``
    are read only by the hierarchical one."""
    if comm_topology != "flat" or allreduce_compress_bf16 \
            or ici_size is not None:
        raise NotImplementedError(
            "the hierarchical comm plan (comm_topology, "
            "allreduce_compress_bf16, ici_size) is not ported yet (ROADMAP "
            "queue 1 item 6, the wider parallel stack)")
    if isinstance(grads, Mapping):
        names = jax_leaf_order(grads)
        leaves = [grads[n] for n in names]
    else:
        names, leaves = None, list(grads)
    if not leaves:
        return []
    trig = None
    if trigger_paths:
        if names is None:
            raise ValueError("trigger_paths need grads keyed by name")
        unknown = set(trigger_paths) - set(names)
        if unknown:
            raise ValueError(f"allreduce_trigger_params paths not found in "
                             f"the gradient tree: {sorted(unknown)}; "
                             f"available: {names[:8]}...")
        trig = {i for i, n in enumerate(names) if n in trigger_paths}
    dtypes = [g.dtype for g in leaves]
    plan = []
    for bucket in _plan_buckets(dtypes, trig):
        dt = dtypes[bucket[0]]
        n = sum(math.prod(leaves[i].shape) for i in bucket)
        comm_dt = torch.float32 if allreduce_always_fp32 else dt
        acct = _bucket_wire_accounting(n, comm_dt, message_size,
                                       delay_allreduce, bool(trig))
        plan.append({
            "dtype": _dtype_name(dt), "comm_dtype": _dtype_name(comm_dt),
            "leaves": len(bucket), "elements": n,
            "chunks": acct["chunks"], "cause": acct["cause"],
            "topology": acct["topology"], "ici_size": 1, "dcn_size": 1,
            "wire_elements": acct["wire_elements"],
            "padded_elements": acct["padded_elements"],
            "wire_bytes": acct["bytes"],
            "ici_wire_bytes": acct["ici_wire_bytes"],
            "dcn_wire_bytes": acct["dcn_wire_bytes"],
            "dcn_comm_dtype": acct["dcn_comm_dtype"],
            "eqns": acct["eqns"],
            "eqn_payload_bytes": acct["eqn_payload_bytes"]})
    return plan


def make_step(step_fn: Callable, module: torch.nn.Module,
              steps_per_call: int = 1, donate_state: bool = True
              ) -> Callable:
    """``train(batch)`` over ``step_fn(batch) -> aux``, one training step
    of ``module`` (``DistributedDataParallel.make_step``'s body, for a
    module with or without the wrapper).

    On the card the step is captured whole in a CUDA graph
    (``apex_tpu_torch._graph``): the first call runs eagerly (the
    warm-up), the second captures and replays, later calls replay, so
    call ``i`` is step ``i``.  ``steps_per_call`` K > 1 captures K steps
    into one graph: every batch tensor is shaped ``(K, per_step...)`` and
    each aux tensor comes back with a leading K axis (the JAX package's
    ``lax.scan``).  The returned aux tensors are copies.  A capture that
    fails raises.  On the CPU the steps run eagerly.

    The CUDA generators ``module``'s submodules hold (BERT's dropout
    generator) are registered with the graph.  The step's state lives in
    the model and the optimizer and is updated in place, which is what
    ``donate_state`` asks of the JAX package's step; ``donate_state=False``
    is refused."""
    K = int(steps_per_call)
    if K < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {K}")
    if not donate_state:
        raise ValueError("donate_state=False: the port's step updates the "
                         "model and the optimizer in place, so its state "
                         "is always donated")
    device = next(module.parameters()).device
    if device.type != "cuda":
        return lambda batch: _graph.tree_map(
            torch.clone, _graph.run_steps(step_fn, batch, K))
    return _graph.CapturedStep(step_fn, K, device,
                               _graph.cuda_generators(module))


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

    def allreduce_grads(self, grads=None):
        """All-reduce grads in buckets (see the module doc) and average
        them over the group.

        ``grads``: the functional step's grads (``amp.scaled_grad``'s
        list, in the JAX package's leaf order of the module's parameter
        names, or a mapping of those names; ``None`` is a zero grad).
        Returns the reduced grads in the same form, new tensors.  With no
        argument, the hook path: the module's ``.grad``s are reduced in
        place (a parameter without a grad contributes zeros and keeps
        ``grad = None``)."""
        if grads is None:
            reduced = self._reduce([
                p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self._params])
            with torch.no_grad():
                for p, r in zip(self._params, reduced):
                    if p.grad is not None:
                        p.grad.copy_(r)
            return None
        if isinstance(grads, Mapping):
            unknown = sorted(set(grads) - set(self._names))
            if unknown:
                raise KeyError(f"grads of no parameter: {unknown[:8]}")
            reduced = self._reduce([
                grads[n] if grads.get(n) is not None
                else torch.zeros_like(p)
                for n, p in zip(self._names, self._params)])
            return dict(zip(self._names, reduced))
        grads = list(grads)
        if len(grads) != len(self._params):
            raise ValueError(f"{len(grads)} grads for {len(self._params)} "
                             f"parameters")
        return self._reduce([g if g is not None else torch.zeros_like(p)
                             for g, p in zip(grads, self._params)])

    def _reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The buckets' all-reduce: each leaf of ``grads`` reduced, as a
        view of its bucket's reduced buffer."""
        world = dist.get_world_size(self.process_group)
        pre, _ = predivide_factors(world, self.gradient_predivide_factor)
        # world / pre in fp32, as the JAX package divides its fp32 axis size
        post = float(np.float32(world) / np.float32(pre))
        stats, retained = [], []
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        dtypes = [g.dtype for g in grads]
        for bucket in _plan_buckets(dtypes, self._triggers):
            dt = dtypes[bucket[0]]
            n = sum(grads[i].numel() for i in bucket)
            comm_dt = torch.float32 if self.allreduce_always_fp32 else dt
            acct = _bucket_wire_accounting(n, comm_dt, self.message_size,
                                           self.delay_allreduce,
                                           bool(self._triggers))
            parts = [grads[i].reshape(-1) for i in bucket]
            if acct["padded_elements"]:
                parts.append(torch.zeros(acct["padded_elements"], dtype=dt,
                                         device=parts[0].device))
            comm = torch.cat(parts).to(comm_dt)
            if pre != 1.0:
                comm = comm / torch.full((), pre, dtype=comm.dtype,
                                         device=comm.device)
            step = acct["wire_elements"] // acct["chunks"]
            for k in range(acct["chunks"]):
                dist.all_reduce(comm[k * step:(k + 1) * step],
                                group=self.process_group)
            comm = comm[:n]
            if self.gradient_average:
                comm = comm / torch.full((), post, dtype=comm.dtype,
                                         device=comm.device)
            reduced = comm.to(dt)
            stats.append({"dtype": _dtype_name(dt),
                          "comm_dtype": _dtype_name(comm_dt),
                          "leaves": len(bucket), "elements": n,
                          **{k: v for k, v in acct.items()
                             if k not in ("eqns", "eqn_payload_bytes")}})
            retained.append(reduced)
            off = 0
            for i in bucket:
                k = grads[i].numel()
                out[i] = reduced[off:off + k].view(grads[i].shape)
                off += k
        self.last_comm_stats = stats
        self.allreduce_buffers = retained if self.retain_allreduce_buffers \
            else []
        return out

    def make_step(self, step_fn: Callable, steps_per_call: int = 1,
                  donate_state: bool = True) -> Callable:
        """``train(batch)`` over ``step_fn(batch) -> aux``, which runs one
        step on this rank's shard and reduces its grads with
        :meth:`allreduce_grads` (``apex_tpu/parallel/distributed.py:1537``);
        captured in a CUDA graph on the card.  See :func:`make_step`."""
        return make_step(step_fn, self.module, steps_per_call, donate_state)


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
