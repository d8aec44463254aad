"""DistributedDataParallel on ``torch.distributed``: the data-parallel core
of ``apex_tpu/parallel/distributed.py``.

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

Where the bytes travel (``comm_topology``): ``"flat"`` is one all-reduce a
chunk over the whole group.  ``"hierarchical"`` reduce-scatters each
bucket within the fast level (the ranks of one node, NVLink:
``ici_size`` of them), all-reduces the 1/ici shard across nodes, and
all-gathers it back within the node (``parallel.topology``'s groups);
``allreduce_compress_bf16`` sends only the cross-node hop in bf16, as a
bf16 all-gather followed by an fp32 sum.  ``"auto"`` is hierarchical when
the world spans nodes.  ``adasum=True`` combines the grads by adaptive
summation (``parallel.adasum``) instead of the sum and mean.

When the bytes travel (``overlap``): with ``overlap=True`` the hook path
issues each bucket's collective (each chunk of a chunked one) on a side
stream as soon as every grad in it has been accumulated, and the
end-of-backward callback only waits for them: the reference Apex's
arrival-order drain.  The buckets, their order and their collectives are
those of ``overlap=False``, so the grads are bitwise the same.
:meth:`DistributedDataParallel.staged_allreduce_grads` is the JAX
package's staged form of the same schedule (a sequential model's stages
reduced as the backward reaches them, :func:`staged_grads`), and
:meth:`~DistributedDataParallel.staged_zero2_allreduce_grads` its ZeRO-2
form (each stage's grads scatter-reduced, its shard updated and the new
params gathered, all as the stage's grads arrive).

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
package's ``jax.jit`` over ``shard_map``), and :func:`allreduce_comm_plan`,
:func:`overlap_comm_schedule` and :func:`zero_update_comm_plan` give the
accounting from shapes alone.

Observability: ``allreduce_grads(grads, numerics_out=[])`` (and the
staged form) gives each bucket's gradient health for a
``observability.NumericsMonitor``, ``record_numerics`` and
``supervisor_signals`` hand the flushed summary to the host side, and
``comm_enabled = False`` makes the compute twin that step-time
attribution times.

The analysis expectations (``plan_collective_expectations``,
``plan_resharding_expectations``, ``overlap_collective_expectations``)
fold the plans into what ``apex_tpu_torch.analysis``'s collective and
resharding-census rules hold a traced step against.
"""

from __future__ import annotations

import itertools
import math
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import _graph
from ..amp._process_optimizer import (_FlatLayout, _validate_zero_knobs,
                                      _zero3_gather_tables, jax_leaf_order)
from . import topology as _topology
from .adasum import adasum_comm_plan, adasum_grads

__all__ = ["DistributedDataParallel", "Reducer", "predivide_factors",
           "flat_dist_call", "ReduceOp", "allreduce_comm_plan",
           "zero_update_comm_plan", "staged_grads", "overlap_comm_schedule",
           "overlap_schedule_fields", "plan_collective_expectations",
           "plan_resharding_expectations",
           "overlap_collective_expectations", "make_step",
           "COMM_TOPOLOGIES", "OVERLAP_MODES"]

COMM_TOPOLOGIES = ("flat", "hierarchical", "auto")
OVERLAP_MODES = ("overlapped", "reduce_after_backward")

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
    so the mean is taken exactly once, however many fabric levels carry
    the sum."""
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


# -- topology knobs and wire accounting ---------------------------------------

def _validate_topology_knobs(comm_topology: str,
                             allreduce_compress_bf16: bool) -> None:
    """The knob rules, shared by the runtime, the plans and the wrapper's
    constructor.  Compression on the flat topology is refused: there is
    no inner level to keep at full precision."""
    if comm_topology not in COMM_TOPOLOGIES:
        raise ValueError(f"comm_topology must be one of {COMM_TOPOLOGIES}, "
                         f"got {comm_topology!r}")
    if allreduce_compress_bf16 and comm_topology == "flat":
        raise ValueError(
            "allreduce_compress_bf16 compresses the cross-node hop of the "
            "hierarchical reduction; comm_topology='flat' has no inner "
            "level to keep full precision (use 'hierarchical' or 'auto')")


def _resolve_topology(comm_topology: str, allreduce_compress_bf16: bool,
                      nproc: Optional[int] = None):
    """``(topology, compress)`` with ``"auto"`` resolved (to flat on one
    node, where compression is dropped: there is no slow hop)."""
    _validate_topology_knobs(comm_topology, allreduce_compress_bf16)
    topo = comm_topology
    if topo == "auto":
        topo = _topology.auto_comm_topology(nproc)
    return topo, (allreduce_compress_bf16 and topo == "hierarchical")


def _bucket_wire_accounting(n: int, comm_dtype: torch.dtype, topo: str,
                            ici: int, compress: bool, message_size: int,
                            delay_allreduce: bool, triggered: bool
                            ) -> Dict[str, Any]:
    """Why a bucket flushed, in how many collectives, and the bytes on the
    wire by level (the JAX package's ``_bucket_wire_accounting``), shared
    by the runtime's ``last_comm_stats`` and the plans, so they cannot
    disagree.  Padding counts: a chunked bucket goes out as ``chunks *
    message_size`` elements, a hierarchical one padded to a multiple of
    ``ici``.  A flat bucket's bytes count on both levels."""
    isz = comm_dtype.itemsize
    if topo == "hierarchical":
        cause = ("trigger" if triggered else
                 "delay" if delay_allreduce else "single")
        n_pad = n + ((-n) % ici)
        m = n_pad // ici
        dcn_dt = torch.bfloat16 if compress else comm_dtype
        dcn_bytes = m * dcn_dt.itemsize
        ici_bytes = n_pad * isz + m * isz        # scatter + gather back
        eqns = {"reduce_scatter": 1, "all_gather": 2 if compress else 1}
        payload = {"reduce_scatter": n_pad * isz,
                   "all_gather": m * isz + (dcn_bytes if compress else 0)}
        if not compress:
            eqns["psum"] = 1
            payload["psum"] = dcn_bytes
        return {"cause": cause, "chunks": 1, "topology": "hierarchical",
                "wire_elements": n_pad, "padded_elements": n_pad - n,
                "bytes": ici_bytes + dcn_bytes,
                "ici_wire_bytes": ici_bytes, "dcn_wire_bytes": dcn_bytes,
                "dcn_comm_dtype": _dtype_name(dcn_dt),
                "eqns": eqns, "eqn_payload_bytes": payload}
    if delay_allreduce or triggered or n <= message_size:
        cause = ("trigger" if triggered
                 else "delay" if delay_allreduce else "single")
        chunks, wire = 1, n
    else:
        cause = "chunked"
        chunks = math.ceil(n / message_size)
        wire = chunks * message_size
    b = wire * isz
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


def _leaves_of(grads: Any):
    """``(names or None, leaves)`` of a mapping (put in the JAX package's
    leaf order) or a list already in it."""
    if isinstance(grads, Mapping):
        names = jax_leaf_order(grads)
        return names, [grads[n] for n in names]
    return None, list(grads)


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
    parameters.  A hierarchical plan (``"auto"`` resolving there with
    ``nproc`` nodes) needs the group's size as ``world``."""
    names, leaves = _leaves_of(grads)
    if not leaves:
        return []
    topo, compress = _resolve_topology(comm_topology,
                                       allreduce_compress_bf16, nproc)
    ici = dcn = 1
    if topo == "hierarchical":
        if world is None:
            raise ValueError("a hierarchical comm plan needs world= (the "
                             "group's size)")
        ici = (int(ici_size) if ici_size is not None
               else _topology.default_ici_size(int(world), nproc))
        _topology.hierarchical_axis_groups(int(world), ici)
        dcn = int(world) // ici
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
        acct = _bucket_wire_accounting(n, comm_dt, topo, ici, compress,
                                       message_size, delay_allreduce,
                                       bool(trig))
        plan.append({
            "dtype": _dtype_name(dt), "comm_dtype": _dtype_name(comm_dt),
            "leaves": len(bucket), "elements": n,
            "chunks": acct["chunks"], "cause": acct["cause"],
            "topology": acct["topology"], "ici_size": ici, "dcn_size": dcn,
            "wire_elements": acct["wire_elements"],
            "padded_elements": acct["padded_elements"],
            "wire_bytes": acct["bytes"],
            "ici_wire_bytes": acct["ici_wire_bytes"],
            "dcn_wire_bytes": acct["dcn_wire_bytes"],
            "dcn_comm_dtype": acct["dcn_comm_dtype"],
            "eqns": acct["eqns"],
            "eqn_payload_bytes": acct["eqn_payload_bytes"]})
    return plan


def plan_collective_expectations(plan: List[dict],
                                 extra_psums: int = 0,
                                 extra_psum_bytes: int = 0) -> dict:
    """Fold an :func:`allreduce_comm_plan` into the ``collectives``
    expectation dict the analysis rule consumes (the JAX package's
    :584): exact per-primitive collective counts, the total on-wire
    payload, and the per-primitive payload split — under the
    hierarchical topology the bucket's psum (or compressed bf16
    all_gather) payload is exactly the cross-node hop.

    ``extra_psums`` / ``extra_psum_bytes`` account for the step's scalar
    all-reduces outside the grad reduction (the loss average)."""
    counts: Dict[str, int] = {}
    by_prim: Dict[str, int] = {}
    total = 0
    for b in plan:
        for prim, k in b["eqns"].items():
            counts[prim] = counts.get(prim, 0) + k
        for prim, by in b["eqn_payload_bytes"].items():
            by_prim[prim] = by_prim.get(prim, 0) + by
        total += b["wire_bytes"]
    if extra_psums:
        counts["psum"] = counts.get("psum", 0) + extra_psums
        by_prim["psum"] = by_prim.get("psum", 0) + extra_psum_bytes
    return {"counts": counts, "payload_bytes": total + extra_psum_bytes,
            "payload_bytes_by_primitive": by_prim}


def plan_resharding_expectations(plan: List[dict],
                                 budget: Optional[Dict[str, int]] = None
                                 ) -> dict:
    """Fold a comm plan (:func:`allreduce_comm_plan` buckets, or
    ``overlap_comm_schedule()["buckets"]``) into the ``resharding``
    expectation the census rule consumes (the JAX package's :614): the
    exact per-collective payload list of every placement-changing
    collective the plan issues.  Per bucket:

    - ``reduce_scatter``: one, the full padded bucket;
    - ``all_gather``: the in-node gather-back of the 1/ici shard; under
      bf16 compression the cross-node reduce is itself an all-gather of
      ``dcn_wire_bytes``, so the bucket contributes two payloads,
      ``[dcn_wire_bytes, total - dcn_wire_bytes]``.

    ``budget`` declares per-primitive counts of resharding collectives
    allowed beyond the plan (default: none)."""
    planned: Dict[str, List[int]] = {}
    for b in plan:
        eqns = b.get("eqns", {})
        payload = b.get("eqn_payload_bytes", {})
        for prim in ("all_gather", "all_to_all", "reduce_scatter",
                     "pgather"):
            k = int(eqns.get(prim, 0))
            if not k:
                continue
            total = int(payload.get(prim, 0))
            if prim == "all_gather" and k == 2:
                dcn = int(b.get("dcn_wire_bytes", 0))
                pays = [dcn, total - dcn]
            elif k == 1:
                pays = [total]
            else:
                pays = [total // k] * k
                pays[0] += total - sum(pays)
            planned.setdefault(prim, []).extend(pays)
    exp: Dict[str, Any] = {"planned": planned}
    if budget:
        exp["budget"] = {k: int(v) for k, v in budget.items()}
    return exp


def overlap_collective_expectations(schedule: Dict[str, Any],
                                    extra_psums: int = 0,
                                    extra_psum_bytes: int = 0) -> dict:
    """Fold an :func:`overlap_comm_schedule` into the collective rule's
    expectation dict (the JAX package's :956): the census of
    :func:`plan_collective_expectations` over the schedule's buckets and,
    for the overlapped mode, the interleaving pin — the first issued
    bucket's reduction ahead of the last conv/matmul of the backward.
    ``min_payload_bytes`` (the smallest per-level hop any bucket puts on
    the wire) separates grad buckets from the step's scalar all-reduces,
    and ``min_collectives_before_last_matmul`` counts the collectives of
    every stage but the last issued (stage 0: the backward drains back
    to front), each issued before that stage's backward."""
    exp = plan_collective_expectations(schedule["buckets"],
                                       extra_psums=extra_psums,
                                       extra_psum_bytes=extra_psum_bytes)
    if schedule["overlap_mode"] == "overlapped" and schedule["buckets"]:
        min_hop = min(
            min(b["dcn_wire_bytes"], b["ici_wire_bytes"])
            for b in schedule["buckets"])
        last_stage = schedule["issue_order"][-1]
        n_before = sum(sum(b["eqns"].values())
                       for b in schedule["buckets"]
                       if b["stage"] != last_stage)
        exp["interleaving"] = {
            "min_payload_bytes": max(int(min_hop), 16),
            "min_matmuls_after": 1,
            "min_collectives_before_last_matmul": int(n_before)}
    return exp


def zero_update_comm_plan(params: Any, *, zero_stage: int, world: int,
                          ici_size: Optional[int] = None,
                          zero_compress_bf16: bool = False) -> List[dict]:
    """The comm plan of one ZeRO-sharded optimizer step, from shapes alone
    (``apex_tpu/parallel/distributed.py:660``), in
    :func:`allreduce_comm_plan`'s schema with a ``role`` a bucket:

    - ``grad_reduce``: stage 1 one reduce-scatter of the padded flat fp32
      buffer over the group (flat accounting); stages 2 and 3 the
      in-node reduce-scatter and the cross-node reduce of the 1/ici shard
      (an all-reduce, or a bf16 all-gather when compressed);
    - ``param_gather`` (stages 1, 2): the updated shard gathered back, a
      bucket a gathered dtype (the half copy, plus fp32 when a float
      parameter stays fp32 or there is no half dtype);
    - ``jit_gather`` (stage 3): ``amp.zero_gather_params``'s gathers, in
      the forward and again when the backward regathers: the half
      gather, plus the small fp32 gather of the exact elements.

    ``params``: a mapping of parameter names to tensors (or anything with
    ``shape`` and ``dtype``)."""
    _validate_zero_knobs(zero_stage, ici_size, zero_compress_bf16)
    layout = _FlatLayout(list(params.items()))
    n = layout.total
    isz = 4
    if zero_stage >= 2:
        ici = int(ici_size)
        _topology.hierarchical_axis_groups(int(world), ici)
        dcn = int(world) // ici
        pop = ici
        topo = "hierarchical"
    else:
        pop = ici = int(world)
        dcn = 1
        topo = "flat"
    n_pad = n + ((-n) % pop)
    m = n_pad // pop
    half = layout.half_dtype
    f32 = [f and d == torch.float32 for f, d in zip(layout.is_float,
                                                     layout.dtypes)]
    n_float = sum(layout.is_float)

    def bucket(role, dtype, leaves, elements, padded, eqns, payload,
               ici_bytes, dcn_bytes, dcn_dt):
        return {"role": role, "zero_stage": int(zero_stage),
                "dtype": _dtype_name(dtype), "comm_dtype": _dtype_name(dtype),
                "leaves": leaves, "elements": elements,
                "chunks": 1, "cause": "zero", "topology": topo,
                "ici_size": ici, "dcn_size": dcn,
                "wire_elements": elements + padded,
                "padded_elements": padded,
                "wire_bytes": sum(payload.values()),
                "ici_wire_bytes": ici_bytes, "dcn_wire_bytes": dcn_bytes,
                "dcn_comm_dtype": _dtype_name(dcn_dt),
                "eqns": eqns, "eqn_payload_bytes": payload}

    plan: List[dict] = []
    if zero_stage >= 2:
        if zero_compress_bf16:
            eqns = {"reduce_scatter": 1, "all_gather": 1}
            payload = {"reduce_scatter": n_pad * isz, "all_gather": m * 2}
            dcn_bytes, dcn_dt = m * 2, torch.bfloat16
        else:
            eqns = {"reduce_scatter": 1, "psum": 1}
            payload = {"reduce_scatter": n_pad * isz, "psum": m * isz}
            dcn_bytes, dcn_dt = m * isz, torch.float32
        plan.append(bucket("grad_reduce", torch.float32, n_float, n,
                           n_pad - n, eqns, payload, n_pad * isz, dcn_bytes,
                           dcn_dt))
    else:
        plan.append(bucket("grad_reduce", torch.float32, n_float, n,
                           n_pad - n, {"reduce_scatter": 1},
                           {"reduce_scatter": n_pad * isz}, n_pad * isz,
                           n_pad * isz, torch.float32))
    if zero_stage == 3:
        if half is not None:
            _, _, n32, m32 = _zero3_gather_tables(layout, ici)
            hsz = half.itemsize
            gathers = [(half, m * hsz)]
            if n32:
                gathers.append((torch.float32, max(m32, 1) * isz))
        else:
            gathers = [(torch.float32, m * isz)]
        for _ in range(2):                     # forward + the regather
            for dt, b in gathers:
                plan.append(bucket("jit_gather", dt, n_float,
                                   b // dt.itemsize, 0, {"all_gather": 1},
                                   {"all_gather": b}, b, 0, dt))
    else:
        gathers = []
        if any(f32) or half is None:
            gathers.append((torch.float32, sum(f32)))
        if half is not None:
            gathers.append((half, sum(1 for f, d in zip(layout.is_float,
                                                        layout.dtypes)
                                      if f and d == half)))
        for dt, leaves in gathers:
            b = m * dt.itemsize
            plan.append(bucket("param_gather", dt, leaves, m, 0,
                               {"all_gather": 1}, {"all_gather": b}, b,
                               b if zero_stage == 1 else 0, dt))
    return plan


# -- the two-level reduce -----------------------------------------------------

def _hier_scatter_reduce(comm: torch.Tensor, ici_group, dcn_group,
                         ici: int, dcn: int, compress: bool,
                         err_out: Optional[list] = None) -> torch.Tensor:
    """The scatter half of the hierarchical reduce: pad to a multiple of
    ``ici``, reduce-scatter within the node, reduce the 1/ici shard across
    nodes (as a bf16 all-gather and an fp32 sum with ``compress``) and
    stop: ZeRO-2's grad reduction (``apex_tpu/parallel/distributed.py:
    216``).  With ``compress`` and an ``err_out`` list, the squared bf16
    quantization error of this rank's shard (a 0-d fp32 tensor, local
    math) is appended to it."""
    pad = (-comm.shape[0]) % ici
    if pad:
        comm = torch.cat([comm, comm.new_zeros(pad)])
    shard = comm.new_empty(comm.shape[0] // ici)
    dist.reduce_scatter_tensor(shard, comm, group=ici_group)
    if compress:
        q = shard.to(torch.bfloat16)
        if err_out is not None:
            d = shard.to(torch.float32) - q.to(torch.float32)
            err_out.append((d * d).sum())
        wire = q.new_empty(dcn * q.shape[0])
        dist.all_gather_into_tensor(wire, q, group=dcn_group)
        shard = wire.view(dcn, -1).to(shard.dtype).sum(0)
    else:
        dist.all_reduce(shard, group=dcn_group)
    return shard


def _hier_gather(shard: torch.Tensor, ici_group, ici: int, n: int
                 ) -> torch.Tensor:
    """The gather half: the 1/ici shard all-gathered within the node, cut
    back to ``n`` elements."""
    full = shard.new_empty(shard.shape[0] * ici)
    dist.all_gather_into_tensor(full, shard, group=ici_group)
    return full[:n]


def _hierarchical_reduce(comm: torch.Tensor, ici_group, dcn_group,
                         ici: int, dcn: int, compress: bool,
                         err_out: Optional[list] = None) -> torch.Tensor:
    """Two-level sum of one flat bucket (``_hierarchical_reduce``,
    distributed.py:192 of the JAX package; ``err_out`` as in
    :func:`_hier_scatter_reduce`)."""
    n = comm.shape[0]
    shard = _hier_scatter_reduce(comm, ici_group, dcn_group, ici, dcn,
                                 compress, err_out)
    return _hier_gather(shard, ici_group, ici, n)


class _CommStream:
    """Where the collectives of an overlapped schedule run.  On a CUDA
    device, a side stream that forks from the current stream at each issue
    and joins it at :meth:`join` (through events, so a CUDA graph capture
    takes both streams in); elsewhere the collectives run in place, in
    issue order."""

    def __init__(self):
        self.stream: Optional[torch.cuda.Stream] = None
        self.forks = 0

    def issue(self, device: torch.device, fn: Callable[[], Any]) -> Any:
        if device.type != "cuda":
            return fn()
        if self.stream is None or self.stream.device != device:
            self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream(device))
        self.forks += 1
        with torch.cuda.stream(self.stream):
            return fn()

    def join(self, device: torch.device) -> None:
        if self.forks and device.type == "cuda":
            torch.cuda.current_stream(device).wait_stream(self.stream)
        self.forks = 0


# -- the overlapped schedule --------------------------------------------------

def _stamp_stage_labels(records: List[dict], stage: int,
                        issue_start: int) -> int:
    """Stamp one stage's bucket records (plan buckets or runtime stats)
    with ``stage`` and ``issue_order``; returns the next issue index.
    Shared by the plan and the runtime, so neither relabels alone."""
    for i, rec in enumerate(records):
        rec["stage"] = int(stage)
        rec["issue_order"] = issue_start + i
    return issue_start + len(records)


def _flatten(tree: Any):
    """``(leaves, rebuild)`` of a tensor, or a list, tuple or dict of
    them (one level)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, Mapping):
        keys = list(tree)
        return [tree[k] for k in keys], lambda ls: dict(zip(keys, ls))
    seq = list(tree)
    return seq, lambda ls: type(tree)(ls) if isinstance(tree, tuple) \
        else list(ls)


def staged_grads(stage_fns: Sequence[Callable], loss_head: Callable,
                 stage_params: Sequence[Any], x: Any,
                 reduce_stage: Optional[Callable] = None,
                 overlap: bool = True):
    """The chain rule over a sequential decomposition, stage by stage
    (``apex_tpu/parallel/distributed.py:813``).

    ``stage_fns[i](stage_params[i], act) -> act`` compose the forward
    (``stage_params[i]``: a tensor, or a list, tuple or dict of the
    tensors the stage trains); ``loss_head(act) -> scalar`` closes over the
    labels.  The backward then walks the stages in
    ``topology.overlap_issue_order`` (last first, as the backward makes
    them) with one ``torch.autograd.grad`` a stage.  With ``overlap=True``
    each stage's ``reduce_stage(stage, issue_idx, grads)`` is called as
    soon as its grads exist, before the next stage's backward; with
    ``False`` the same calls come in the same order after the whole
    backward.  Returns ``(loss, grads)``, the loss detached and the grads
    in stage order, each in its stage's structure, reduced when
    ``reduce_stage`` is given."""
    n = len(stage_fns)
    if n != len(stage_params):
        raise ValueError(f"{n} stage fns vs {len(stage_params)} stage "
                         f"param trees")
    order = _topology.overlap_issue_order(n)
    ins, outs = [], []
    act = x
    for s, (fn, p) in enumerate(zip(stage_fns, stage_params)):
        a_in = act if s == 0 else act.detach().requires_grad_()
        ins.append(a_in)
        act = fn(p, a_in)
        outs.append(act)
    last = act.detach().requires_grad_()
    loss = loss_head(last)
    (ct,) = torch.autograd.grad(loss, [last])
    grads: List[Any] = [None] * n
    for issue, s in enumerate(order):
        leaves, rebuild = _flatten(stage_params[s])
        wrt = list(leaves) + ([ins[s]] if s > 0 else [])
        got = torch.autograd.grad(outs[s], wrt, grad_outputs=ct,
                                  allow_unused=True)
        g = [torch.zeros_like(p) if d is None else d
             for p, d in zip(leaves, got)]
        if s > 0:
            ct = got[-1]
        g = rebuild(g)
        if overlap and reduce_stage is not None:
            g = reduce_stage(s, issue, g)
        grads[s] = g
    if not overlap and reduce_stage is not None:
        for issue, s in enumerate(order):
            grads[s] = reduce_stage(s, issue, grads[s])
    return loss.detach(), grads


def overlap_comm_schedule(stage_trees: Sequence[Any],
                          message_size: int = 10_000_000,
                          allreduce_always_fp32: bool = False,
                          comm_topology: str = "flat",
                          allreduce_compress_bf16: bool = False,
                          ici_size: Optional[int] = None,
                          world: Optional[int] = None,
                          nproc: Optional[int] = None,
                          overlap: bool = True,
                          zero_stage: Optional[int] = None
                          ) -> Dict[str, Any]:
    """The static overlap schedule (``apex_tpu/parallel/distributed.py:
    869``): :func:`allreduce_comm_plan` of each stage's tree, the stages
    in issue order, each bucket stamped with ``stage`` and
    ``issue_order``::

        {"overlap_mode", "n_stages", "issue_order": [S-1, ..., 0],
         "zero_stage", "buckets": [...]}

    ``zero_stage=2`` tags the fused ZeRO-2 staged step, whose wire
    accounting is the hierarchical schedule's (the in-node gather carries
    the updated params instead of the reduced grads)."""
    if zero_stage is not None:
        if zero_stage != 2:
            raise ValueError(
                f"overlap_comm_schedule composes with ZeRO stage 2 only "
                f"(stage 3's gather lives in the forward, not the grad "
                f"schedule); got zero_stage={zero_stage!r}")
        if comm_topology != "hierarchical":
            raise ValueError("the fused ZeRO-2 staged schedule shards over "
                             "the node; comm_topology must be "
                             "'hierarchical'")
    order = _topology.overlap_issue_order(len(stage_trees))
    buckets: List[dict] = []
    issue = 0
    for s in order:
        tree = stage_trees[s]
        if not isinstance(tree, Mapping):
            tree = _flatten(tree)[0]
        stage_buckets = allreduce_comm_plan(
            tree, message_size=message_size,
            allreduce_always_fp32=allreduce_always_fp32,
            comm_topology=comm_topology,
            allreduce_compress_bf16=allreduce_compress_bf16,
            ici_size=ici_size, world=world, nproc=nproc)
        issue = _stamp_stage_labels(stage_buckets, s, issue)
        buckets.extend(stage_buckets)
    return {"overlap_mode": "overlapped" if overlap
            else "reduce_after_backward",
            "n_stages": len(stage_trees), "issue_order": order,
            "zero_stage": zero_stage, "buckets": buckets}


def overlap_schedule_fields(schedule: Optional[Dict[str, Any]]
                            ) -> Dict[str, Any]:
    """The schedule fields a measurement record carries: mode, stage count
    and stage issue order (``zero_stage`` only when set).  ``None`` is the
    classic step: one stage, reduced after the backward."""
    if schedule is None:
        return {"overlap_mode": "reduce_after_backward", "n_stages": 1,
                "issue_order": [0]}
    out = {"overlap_mode": schedule["overlap_mode"],
           "n_stages": int(schedule["n_stages"]),
           "issue_order": [int(s) for s in schedule["issue_order"]]}
    if schedule.get("zero_stage") is not None:
        out["zero_stage"] = int(schedule["zero_stage"])
    return out


def make_step(step_fn: Callable, module: torch.nn.Module,
              steps_per_call: int = 1, donate_state: bool = True
              ) -> Callable:
    """``train(batch)`` over ``step_fn(batch) -> aux``, one training step
    of ``module`` (``DistributedDataParallel.make_step``'s body, for a
    module with or without the wrapper).

    On the card the step is captured whole in a CUDA graph
    (``apex_tpu_torch._graph``): the first call runs eagerly (the
    warm-up, which also makes every NCCL communicator the step uses), the
    second captures and replays, later calls replay, so call ``i`` is step
    ``i``.  ``steps_per_call`` K > 1 captures K steps into one graph:
    every batch tensor is shaped ``(K, per_step...)`` and each aux tensor
    comes back with a leading K axis (the JAX package's ``lax.scan``).
    The returned aux tensors are copies.  A capture that fails raises.  On
    the CPU the steps run eagerly.

    The CUDA generators ``module``'s submodules hold (BERT's dropout
    generator) are registered with the graph.  The step's state lives in
    the model and the optimizer (a ZeRO-sharded one too) and is updated in
    place, which is what ``donate_state`` asks of the JAX package's step;
    ``donate_state=False`` is refused.

    The compilation ledger (``observability.compilation``) records the
    capture under the entry ``make_step``, timed; on the CPU, the first
    call at each batch signature."""
    K = int(steps_per_call)
    if K < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {K}")
    if not donate_state:
        raise ValueError("donate_state=False: the port's step updates the "
                         "model and the optimizer in place, so its state "
                         "is always donated")
    from ..observability import compilation
    device = next(module.parameters()).device
    if device.type != "cuda":
        def train(batch):
            return _graph.tree_map(torch.clone,
                                   _graph.run_steps(step_fn, batch, K))
        return compilation.instrumented_jit(train, "make_step",
                                            arg_names=("batch",))
    return compilation.instrumented_jit(
        _graph.CapturedStep(step_fn, K, device,
                            _graph.cuda_generators(module)), "make_step")


# -- the wrapper --------------------------------------------------------------

class _Bucket:
    """One bucket of a reduction: its leaves, dtypes, accounting and the
    units its collectives go out in (ranges of its wire buffer: a chunk
    each of a chunked flat bucket, else the whole buffer)."""

    def __init__(self, idxs, sizes, dt, comm_dt, acct, hier: bool):
        self.idxs = list(idxs)
        self.sizes = [sizes[i] for i in self.idxs]
        self.offsets = [0, *itertools.accumulate(self.sizes)][:-1]
        self.dt, self.comm_dt, self.acct = dt, comm_dt, acct
        self.n = int(sum(self.sizes))
        self.hier = hier
        self.wire = acct["wire_elements"]
        k = acct["chunks"]
        step = self.wire // k
        self.units = [(u * step, (u + 1) * step) for u in range(k)]
        # the units each leaf lies in
        self.leaf_units = [
            [u for u, (lo, hi) in enumerate(self.units)
             if off < hi and off + sz > lo] or [0]
            for off, sz in zip(self.offsets, self.sizes)]


class _Pending:
    """A reduction in flight: each bucket's wire buffer, what is still to
    be filled before each unit goes out, and the results."""

    def __init__(self, buckets: List[_Bucket], device):
        self.buckets = buckets
        self.bufs = [torch.zeros(b.wire, dtype=b.comm_dt, device=device)
                     for b in buckets]
        self.missing = [[sum(u in lu for lu in b.leaf_units)
                         for u in range(len(b.units))] for b in buckets]
        self.issued = [[False] * len(b.units) for b in buckets]
        self.results: List[Optional[torch.Tensor]] = [None] * len(buckets)
        # the buckets' numerics records, when the caller asked for them
        self.nstats: Optional[List[dict]] = None
        self.where = {i: (k, j) for k, b in enumerate(buckets)
                      for j, i in enumerate(b.idxs)}


class DistributedDataParallel(torch.nn.Module):
    """Model wrapper with the reference's constructor surface; see the
    module doc.  ``process_group`` takes the place of the JAX package's
    ``axis_name`` (``None``: the world).  ``zero_stage=2`` arms
    :meth:`staged_zero2_allreduce_grads` (stages 1 and 3 shard inside the
    amp optimizer: ``AmpOptimizer.zero_shard``)."""

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
        _validate_topology_knobs(comm_topology, allreduce_compress_bf16)
        if adasum:
            clashes = [name for name, bad in (
                ("delay_allreduce", delay_allreduce),
                ("allreduce_trigger_params", bool(allreduce_trigger_params)),
                ("retain_allreduce_buffers", retain_allreduce_buffers),
                ("allreduce_always_fp32", allreduce_always_fp32),
                ("allreduce_compress_bf16", allreduce_compress_bf16),
                ("gradient_average=False", not gradient_average),
                ("gradient_predivide_factor",
                 gradient_predivide_factor != 1.0)) if bad]
            if clashes:
                raise ValueError(f"adasum=True replaces the psum pipeline; "
                                 f"these options have no effect with it: "
                                 f"{clashes}")
        if overlap:
            clashes = [name for name, bad in (
                ("delay_allreduce", delay_allreduce),
                ("allreduce_trigger_params", bool(allreduce_trigger_params)),
                ("adasum", adasum)) if bad]
            if clashes:
                raise ValueError(f"overlap=True issues bucket reductions "
                                 f"inside the backward; these options "
                                 f"contradict that schedule: {clashes}")
        if zero_stage is not None:
            if zero_stage != 2:
                raise ValueError(
                    f"DistributedDataParallel composes with ZeRO stage 2 "
                    f"only (stages 1/3 live in the amp optimizer's "
                    f"flat-buffer step); got zero_stage={zero_stage!r}")
            if comm_topology != "hierarchical":
                raise ValueError("zero_stage=2 shards the update over the "
                                 "node; comm_topology must be "
                                 "'hierarchical'")
            if adasum:
                raise ValueError("zero_stage=2 does not compose with adasum "
                                 "(the butterfly replaces the "
                                 "reduce-scatter the shard rides on)")
        _require_initialized("DistributedDataParallel")
        self.module = module
        self.message_size = int(message_size)
        self.delay_allreduce = bool(delay_allreduce)
        self.allreduce_trigger_params = allreduce_trigger_params
        self.retain_allreduce_buffers = bool(retain_allreduce_buffers)
        self.allreduce_always_fp32 = bool(allreduce_always_fp32)
        self.gradient_average = bool(gradient_average)
        self.gradient_predivide_factor = float(gradient_predivide_factor)
        self.process_group = process_group
        self.adasum = bool(adasum)
        self.comm_topology = comm_topology
        self.allreduce_compress_bf16 = bool(allreduce_compress_bf16)
        self.ici_size = ici_size
        self.overlap = bool(overlap)
        self.zero_stage = zero_stage
        self.allreduce_buffers: List[torch.Tensor] = []
        self.last_comm_stats: List[Dict[str, Any]] = []
        self.last_overlap_schedule: Optional[Dict[str, Any]] = None
        # the last flushed NumericsMonitor summary (host-side, set by
        # record_numerics after the step's flush)
        self.last_numerics: Dict[str, Any] = {}
        # False builds the COMPUTE TWIN of a step for step-time
        # attribution (observability.steptime): the gradient collectives
        # are elided while the local average they would have applied
        # stays.  It trains on local grads: a measurement device, not a
        # training mode.
        self.comm_enabled = True

        self.world = dist.get_world_size(process_group)
        self._topo, self._compress = _resolve_topology(
            comm_topology, allreduce_compress_bf16)
        self._ici = 1
        self._groups = (None, None)
        if self._topo == "hierarchical":
            self._ici = (int(ici_size) if ici_size is not None
                         else _topology.default_ici_size(self.world))
            # over a process group the node groups lie inside its ranks
            self._groups = _topology.hierarchical_groups(
                self._ici, self.world, None if process_group is None
                else dist.get_process_group_ranks(process_group))
        self._comm = _CommStream()

        by_name = dict(module.named_parameters())
        self._names = jax_leaf_order(by_name)
        self._params = [by_name[n] for n in self._names]
        self._index = {id(p): i for i, p in enumerate(self._params)}
        self._triggers = self._trigger_indices(allreduce_trigger_params)
        self._queued = False
        self._pending: Optional[_Pending] = None
        self._compute_stream = None
        self.broadcast_params()
        # the hooks live in the params' C++ grad accumulators, where the
        # garbage collector cannot see them: a strong reference to self
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

    # -- the buckets ----------------------------------------------------------
    def _buckets(self, dtypes, sizes, triggers) -> List[_Bucket]:
        out = []
        for idxs in _plan_buckets(dtypes, triggers):
            dt = dtypes[idxs[0]]
            n = sum(sizes[i] for i in idxs)
            comm_dt = torch.float32 if self.allreduce_always_fp32 else dt
            acct = _bucket_wire_accounting(
                n, comm_dt, self._topo, self._ici, self._compress,
                self.message_size, self.delay_allreduce, bool(triggers))
            out.append(_Bucket(idxs, sizes, dt, comm_dt, acct,
                               self._topo == "hierarchical"))
        return out

    def _factors(self):
        pre, _ = predivide_factors(self.world,
                                   self.gradient_predivide_factor)
        # world / pre in fp32, as the JAX package divides its fp32 axis size
        return pre, float(np.float32(self.world) / np.float32(pre))

    def _start(self, grads: List[torch.Tensor]) -> _Pending:
        """Buffers for a reduction of ``grads`` (a list in leaf order), with
        nothing filled or issued yet."""
        buckets = self._buckets([g.dtype for g in grads],
                                [g.numel() for g in grads], self._triggers)
        return _Pending(buckets, grads[0].device)

    def _fill(self, pend: _Pending, i: int, g: Optional[torch.Tensor],
              issue: bool) -> None:
        """Leaf ``i``'s grad into its bucket's buffer (a missing grad is the
        buffer's zeros); with ``issue``, every unit that is then complete
        goes out."""
        k, j = pend.where[i]
        b = pend.buckets[k]
        if g is not None:
            off = b.offsets[j]
            pend.bufs[k][off:off + b.sizes[j]].copy_(g.detach().reshape(-1))
        for u in b.leaf_units[j]:
            pend.missing[k][u] -= 1
            if issue and pend.missing[k][u] == 0:
                self._issue(pend, k, u)

    def _issue(self, pend: _Pending, k: int, u: int) -> None:
        """One unit's collective(s), on the comm stream when overlapping."""
        if pend.issued[k][u]:
            return
        pend.issued[k][u] = True
        b, buf = pend.buckets[k], pend.bufs[k]
        pre, _ = self._factors()

        def run():
            lo, hi = b.units[u]
            piece = buf[lo:hi]
            if pre != 1.0:
                piece.div_(torch.full((), pre, dtype=buf.dtype,
                                      device=buf.device))
            if b.hier:
                ici_g, dcn_g = self._groups
                err = ([] if pend.nstats is not None and self._compress
                       else None)
                red = _hierarchical_reduce(buf, ici_g, dcn_g, self._ici,
                                           self.world // self._ici,
                                           self._compress, err)
                if err:
                    pend.nstats[k]["compression_sq_error"] = err[0]
                return red
            dist.all_reduce(piece, group=self.process_group)
            return None

        out = (self._comm.issue(buf.device, run) if self.overlap
               else run())
        if out is not None:
            if self.overlap and out.is_cuda:
                # made on the comm stream, read on the compute stream
                out.record_stream(torch.cuda.current_stream(out.device))
            pend.results[k] = out

    def _finish(self, pend: _Pending, grads: List[torch.Tensor]
                ) -> List[torch.Tensor]:
        """Issue what is left, wait for the comm stream, and return each
        leaf reduced (a view of its bucket's reduced buffer); the stats
        and retained buffers recorded."""
        for k, b in enumerate(pend.buckets):
            for u in range(len(b.units)):
                self._issue(pend, k, u)
        if self.overlap:
            self._comm.join(pend.bufs[0].device)
            for rec in pend.nstats or ():
                err = rec.get("compression_sq_error")
                if err is not None and err.is_cuda:
                    # made on the comm stream, read on the compute stream
                    err.record_stream(torch.cuda.current_stream(err.device))
        _, post = self._factors()
        stats, retained = [], []
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        for k, b in enumerate(pend.buckets):
            red = (pend.results[k] if b.hier else pend.bufs[k])[:b.n]
            if self.gradient_average:
                red = red / torch.full((), post, dtype=red.dtype,
                                       device=red.device)
            red = red.to(b.dt)
            stats.append({"dtype": _dtype_name(b.dt),
                          "comm_dtype": _dtype_name(b.comm_dt),
                          "leaves": len(b.idxs), "elements": b.n,
                          **{key: v for key, v in b.acct.items()
                             if key not in ("eqns", "eqn_payload_bytes")}})
            retained.append(red)
            for i, off, sz in zip(b.idxs, b.offsets, b.sizes):
                out[i] = red[off:off + sz].view(grads[i].shape)
        self.last_comm_stats = stats
        self.allreduce_buffers = retained if self.retain_allreduce_buffers \
            else []
        return out

    def _bucket_numerics(self, pend: _Pending,
                         numerics_out: Optional[list]) -> None:
        """Each bucket's health on its filled, pre-divide communication
        buffer (what goes on the wire), appended to ``numerics_out`` in
        bucket order: the static identity plus device scalars
        ``nonfinite`` / ``abs_max`` / ``sq_sum`` (nonfinite masked out of
        the magnitudes), and ``compression_sq_error`` once a compressed
        hierarchical bucket is issued.  Local math: no collective."""
        if numerics_out is None:
            return
        pend.nstats = []
        for k, b in enumerate(pend.buckets):
            x = pend.bufs[k][:b.n].to(torch.float32)
            fin = torch.isfinite(x)
            ax = torch.abs(torch.where(fin, x, torch.zeros_like(x)))
            pend.nstats.append({
                "dtype": _dtype_name(b.dt),
                "comm_dtype": _dtype_name(b.comm_dt),
                "leaves": len(b.idxs), "elements": b.n,
                "nonfinite": (~fin).sum().to(torch.float32),
                "abs_max": torch.amax(ax) if b.n else ax.new_zeros(()),
                "sq_sum": (ax * ax).sum()})
        numerics_out.extend(pend.nstats)

    def _reduce(self, grads: List[torch.Tensor],
                numerics_out: Optional[list] = None) -> List[torch.Tensor]:
        """The buckets' reduction of ``grads`` (a list in leaf order): each
        leaf reduced, as a view of its bucket's reduced buffer."""
        if self.adasum:
            (plan,) = adasum_comm_plan(grads, self.world, self._ici)
            self.last_comm_stats = [{**plan, "topology": self._topo}]
            return adasum_grads(grads, self.process_group, self._ici)
        pend = self._start(grads)
        for i, g in enumerate(grads):
            self._fill(pend, i, g, issue=False)
        self._bucket_numerics(pend, numerics_out)
        return self._finish(pend, grads)

    def _local_average(self, g: torch.Tensor) -> torch.Tensor:
        """The compute twin's stand-in for a reduction: the average's
        division by the world, without the collective."""
        if (not self.gradient_average or self.adasum
                or not g.is_floating_point()):
            return g
        return g / torch.full((), float(self.world), dtype=g.dtype,
                              device=g.device)

    # -- the end-of-backward all-reduce ----------------------------------------
    def _grad_ready(self, param) -> None:
        if self.zero_stage is not None:
            return
        if not self._queued:
            self._queued = True
            self._compute_stream = (torch.cuda.current_stream(param.device)
                                    if param.is_cuda else None)
            if self.overlap:
                self._pending = self._start(
                    [p if p.grad is None else p.grad for p in self._params])
            torch.autograd.Variable._execution_engine.queue_callback(
                self._after_backward)
        if self._pending is not None:
            self._fill(self._pending, self._index[id(param)], param.grad,
                       issue=True)

    def _after_backward(self) -> None:
        self._queued = False
        stream, self._compute_stream = self._compute_stream, None
        if stream is None:
            self._reduce_hooked()
            return
        with torch.cuda.stream(stream):
            self._reduce_hooked()

    def _reduce_hooked(self) -> None:
        """The hook path's reduction of the ``.grad``s, in place (a
        parameter without a grad contributes zeros and keeps ``grad =
        None``); when overlapping, what the hooks have not issued goes out
        now and the comm stream is waited for."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        if self._pending is not None:
            pend, self._pending = self._pending, None
            reduced = self._finish(pend, grads)
        else:
            reduced = self._reduce(grads)
        with torch.no_grad():
            for p, r in zip(self._params, reduced):
                if p.grad is not None:
                    p.grad.copy_(r)

    def allreduce_grads(self, grads=None, numerics_out=None):
        """All-reduce grads in buckets (see the module doc) and average
        them over the group.

        ``grads``: the functional step's grads (``amp.scaled_grad``'s
        list, in the JAX package's leaf order of the module's parameter
        names, or a mapping of those names; ``None`` is a zero grad).
        Returns the reduced grads in the same form, new tensors.  With no
        argument, the hook path: the module's ``.grad``s are reduced in
        place.

        ``numerics_out``: a list that receives one dict a bucket, in the
        order of :func:`allreduce_comm_plan` (the JAX package's
        ``numerics_out``): the bucket's identity and device scalars of
        its pre-divide buffer (``nonfinite``, ``abs_max``, ``sq_sum``,
        and ``compression_sq_error`` of this rank's shard on the bf16
        cross-node hop), for ``NumericsMonitor.update(bucket_stats=)``.
        Functional path only (it needs the grads before they go out).

        ``comm_enabled = False`` makes this the compute twin of
        step-time attribution: no collective, the grads divided by the
        world as the average would (``last_comm_stats`` empty)."""
        if numerics_out is not None and grads is None:
            raise ValueError("numerics_out needs the functional step's "
                             "grads: allreduce_grads(grads, "
                             "numerics_out=...)")
        if self.zero_stage is not None:
            raise ValueError(
                "zero_stage=2 shards the update: a full-gradient allreduce "
                "would gather bytes the shard update never reads; use "
                "staged_zero2_allreduce_grads (or the amp optimizer's "
                "zero_shard step)")
        if not self.comm_enabled:
            self.last_comm_stats = []
            if grads is None:
                with torch.no_grad():
                    for p in self._params:
                        if p.grad is not None:
                            p.grad.copy_(self._local_average(p.grad))
                return None
            if isinstance(grads, Mapping):
                return {n: None if g is None else self._local_average(g)
                        for n, g in grads.items()}
            return [None if g is None else self._local_average(g)
                    for g in grads]
        if grads is None:
            self._reduce_hooked()
            return None
        if isinstance(grads, Mapping):
            unknown = sorted(set(grads) - set(self._names))
            if unknown:
                raise KeyError(f"grads of no parameter: {unknown[:8]}")
            reduced = self._reduce([
                grads[n] if grads.get(n) is not None
                else torch.zeros_like(p)
                for n, p in zip(self._names, self._params)], numerics_out)
            return dict(zip(self._names, reduced))
        grads = list(grads)
        if len(grads) != len(self._params):
            raise ValueError(f"{len(grads)} grads for {len(self._params)} "
                             f"parameters")
        return self._reduce([g if g is not None else torch.zeros_like(p)
                             for g, p in zip(grads, self._params)],
                            numerics_out)

    # -- the staged schedules -------------------------------------------------
    def _schedule(self, n_stages: int, stats, zero_stage=None) -> None:
        self.last_comm_stats = stats
        self.last_overlap_schedule = {
            "overlap_mode": "overlapped" if self.overlap
            else "reduce_after_backward",
            "n_stages": n_stages,
            "issue_order": _topology.overlap_issue_order(n_stages),
            "buckets": stats, "world": self.world}
        if zero_stage is not None:
            self.last_overlap_schedule["zero_stage"] = zero_stage

    def staged_allreduce_grads(self, stage_fns: Sequence[Callable],
                               loss_head: Callable,
                               stage_params: Sequence[Any], x: Any,
                               numerics_out=None):
        """Forward and backward over a sequential stage decomposition
        (:func:`staged_grads`) with each stage's grads reduced in buckets
        under this wrapper's knobs as they arrive (``overlap=True``: on
        the comm stream, while the earlier stages' backward runs) or after
        the whole backward (``False``, the baseline).  The schedule moves
        when the buckets go out, never what they carry.  Returns
        ``(loss, grads)``; ``last_comm_stats`` holds the buckets stamped
        with ``stage`` and ``issue_order`` in :func:`overlap_comm_schedule`
        order, and ``last_overlap_schedule`` the schedule.  The world size
        is known on the host: no collective for it.  ``numerics_out``
        receives the buckets' records as :meth:`allreduce_grads` gives
        them, stamped with ``stage`` and ``issue_order`` like the stats.
        ``comm_enabled = False``: the compute twin (the same staged
        backward, no collective, the grads divided by the world)."""
        if self.adasum:
            raise ValueError("staged_allreduce_grads does not compose with "
                             "adasum (the butterfly replaces the bucket "
                             "pipeline)")
        if self.zero_stage is not None:
            raise ValueError("zero_stage=2 replaces the per-stage "
                             "gather-back of grads with a gather of "
                             "updated params; use "
                             "staged_zero2_allreduce_grads")
        if self.delay_allreduce or self.allreduce_trigger_params:
            raise ValueError("staged_allreduce_grads: stage boundaries "
                             "define the buckets; delay_allreduce / "
                             "allreduce_trigger_params contradict the "
                             "staged schedule")
        if not self.comm_enabled:
            self.last_comm_stats = []
            self.last_overlap_schedule = None
            loss, grads = staged_grads(stage_fns, loss_head, stage_params, x,
                                       reduce_stage=None,
                                       overlap=self.overlap)
            out = []
            for gs in grads:
                leaves, rebuild = _flatten(gs)
                out.append(rebuild([self._local_average(g) for g in leaves]))
            return loss, out
        pending = []
        n_issued = [0]

        def reduce_stage(stage, issue, grads_s):
            # every unit of the stage's buckets goes out now (on the comm
            # stream when overlapping); the results are read after the
            # backward
            leaves, rebuild = _flatten(grads_s)
            pend = self._start(leaves)
            for i, g in enumerate(leaves):
                self._fill(pend, i, g, issue=False)
            nout = [] if numerics_out is not None else None
            self._bucket_numerics(pend, nout)
            if nout is not None:
                n_issued[0] = _stamp_stage_labels(nout, stage, n_issued[0])
                numerics_out.extend(nout)
            for k, b in enumerate(pend.buckets):
                for u in range(len(b.units)):
                    self._issue(pend, k, u)
            pending.append((stage, pend, leaves, rebuild))

        loss, _ = staged_grads(stage_fns, loss_head, stage_params, x,
                               reduce_stage=reduce_stage,
                               overlap=self.overlap)
        grads: List[Any] = [None] * len(stage_fns)
        stats: List[dict] = []
        retained: List[torch.Tensor] = []
        for stage, pend, leaves, rebuild in pending:
            grads[stage] = rebuild(self._finish(pend, leaves))
            _stamp_stage_labels(self.last_comm_stats, stage, len(stats))
            stats.extend(self.last_comm_stats)
            retained.extend(self.allreduce_buffers)
        self.allreduce_buffers = retained
        self._schedule(len(stage_fns), stats)
        return loss, grads

    def staged_zero2_allreduce_grads(self, stage_fns: Sequence[Callable],
                                     loss_head: Callable,
                                     stage_params: Sequence[Any], x: Any,
                                     update_shard: Callable):
        """The fused ZeRO-2 staged step (``zero_stage=2``; the JAX
        package's :1343): the staged backward of
        :meth:`staged_allreduce_grads`, where each stage's reduction is
        its sharded update instead -

        1. the stage's flat grads (one dtype a stage) scatter-reduced to
           this rank's 1/ici shard (the in-node reduce-scatter and the
           cross-node reduce of the hierarchical all-reduce);
        2. ``update_shard(stage, param_shard, grad_shard) -> new_shard``
           on this rank's window of the stage's flat params (padded to a
           multiple of ``ici``), in the params' dtype;
        3. the new shards all-gathered within the node (the bytes the
           plain schedule spends gathering reduced grads).

        With ``overlap=True`` all three are issued on the comm stream as
        the stage's grads arrive.  Returns ``(loss, new_stage_params)``,
        each stage's new params in its structure (the caller writes them
        into the model)."""
        if self.zero_stage != 2:
            raise ValueError("staged_zero2_allreduce_grads requires "
                             "DistributedDataParallel(zero_stage=2, "
                             "comm_topology='hierarchical')")
        if not self.comm_enabled:
            raise ValueError(
                "the ZeRO-2 compute twin is not wired: eliding the "
                "scatter-reduce would update each shard with local "
                "grads and the gathered params would diverge")
        ici = self._ici
        ici_g, dcn_g = self._groups
        pre, post = self._factors()
        idx = dist.get_rank() % ici
        stats: List[dict] = []
        results: Dict[int, Any] = {}
        # made on the compute stream and read on the comm stream: held until
        # the join, so the allocator cannot hand their blocks to a later
        # stage's backward while the comm stream still reads them
        in_flight: List[torch.Tensor] = []

        def reduce_stage(stage, issue, grads_s):
            leaves, rebuild = _flatten(grads_s)
            dts = {g.dtype for g in leaves}
            if len(dts) != 1:
                raise ValueError(
                    f"stage {stage} mixes gradient dtypes {dts}: the fused "
                    f"shard update runs on one flat buffer a stage; cast "
                    f"the stage's params to one dtype")
            (dt,) = dts
            comm_dt = torch.float32 if self.allreduce_always_fp32 else dt
            p_leaves, _ = _flatten(stage_params[stage])
            n = sum(g.numel() for g in leaves)
            m = (n + (-n) % ici) // ici
            flat = torch.cat([g.reshape(-1) for g in leaves]).to(comm_dt)
            flat_par = torch.cat([p.detach().reshape(-1) for p in p_leaves]
                                 + [p_leaves[0].new_zeros(m * ici - n)])
            p_shard = flat_par[idx * m:(idx + 1) * m]
            in_flight.extend((flat, flat_par, p_shard))

            def run():
                comm = flat
                if pre != 1.0:
                    comm = comm / torch.full((), pre, dtype=comm.dtype,
                                             device=comm.device)
                g_shard = _hier_scatter_reduce(comm, ici_g, dcn_g, ici,
                                               self.world // ici,
                                               self._compress)
                if self.gradient_average:
                    g_shard = g_shard / torch.full(
                        (), post, dtype=g_shard.dtype, device=g_shard.device)
                new = update_shard(stage, p_shard, g_shard.to(dt))
                return _hier_gather(new, ici_g, ici, n)

            full = (self._comm.issue(flat.device, run) if self.overlap
                    else run())
            if self.overlap and full.is_cuda:
                full.record_stream(torch.cuda.current_stream(full.device))
            out, off = [], 0
            for g in leaves:
                out.append(full[off:off + g.numel()].view(g.shape))
                off += g.numel()
            results[stage] = rebuild(out)
            acct = _bucket_wire_accounting(n, comm_dt, "hierarchical", ici,
                                           self._compress, self.message_size,
                                           False, False)
            rec = {"dtype": _dtype_name(dt),
                   "comm_dtype": _dtype_name(comm_dt),
                   "leaves": len(leaves), "elements": n,
                   **{k: v for k, v in acct.items()
                      if k not in ("eqns", "eqn_payload_bytes")}}
            _stamp_stage_labels([rec], stage, len(stats))
            stats.append(rec)

        loss, _ = staged_grads(stage_fns, loss_head, stage_params, x,
                               reduce_stage=reduce_stage,
                               overlap=self.overlap)
        if self.overlap:
            self._comm.join(_first_device(stage_params))
        in_flight.clear()
        self._schedule(len(stage_fns), stats, zero_stage=2)
        return loss, [results[s] for s in range(len(stage_fns))]

    # -- observability --------------------------------------------------------
    def supervisor_signals(self) -> Dict[str, Any]:
        """The wrapper's host-side signal bundle for a training-run
        supervisor (``observability.supervisor.RunSupervisor``): the comm
        accounting and the last flushed numerics summary.  Everything
        here is plain Python the wrapper already holds — feeding it to
        ``observe_step(comm_stats=..., numerics=...)`` costs no device
        traffic."""
        return {"comm_stats": list(self.last_comm_stats),
                "numerics": dict(self.last_numerics)}

    def record_numerics(self, flushed: Dict[str, Any]) -> Dict[str, Any]:
        """Fold a flushed ``NumericsMonitor`` summary into the wrapper's
        observability surface: ``ddp.last_numerics`` plus the per-bucket
        compression-error gauges and nonfinite counters in the process
        registry — what the bf16 cross-node hop loses on the wire, next
        to the byte counters that say what it saves."""
        self.last_numerics = dict(flushed)
        from ..observability import get_registry
        reg = get_registry()
        for b in flushed.get("buckets", ()):
            reg.gauge(
                "ddp_allreduce_compression_sq_error",
                help="squared bf16 quantization error of one replica's "
                     "DCN-hop shard, accumulated over observed steps"
            ).labels(bucket=b["label"]).set(
                b.get("compression_sq_error", 0.0))
            reg.counter(
                "ddp_allreduce_bucket_nonfinite_total",
                help="nonfinite gradient elements seen per comm bucket"
            ).labels(bucket=b["label"]).set_total(b["nonfinite"])
        return self.last_numerics

    def make_step(self, step_fn: Callable, steps_per_call: int = 1,
                  donate_state: bool = True) -> Callable:
        """``train(batch)`` over ``step_fn(batch) -> aux``, which runs one
        step on this rank's shard and reduces its grads with
        :meth:`allreduce_grads` (or steps a ZeRO-sharded optimizer, which
        reduces its own) (``apex_tpu/parallel/distributed.py:1537``);
        captured in a CUDA graph on the card.  See :func:`make_step`."""
        return make_step(step_fn, self.module, steps_per_call, donate_state)


def _first_device(stage_params) -> torch.device:
    for tree in stage_params:
        leaves, _ = _flatten(tree)
        if leaves:
            return leaves[0].device
    return torch.device("cpu")


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
