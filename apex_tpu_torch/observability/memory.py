"""Memory observability: the memory plans of captured graphs, analytic
liveness, and live device gauges.

Counterpart of ``apex_tpu/observability/memory.py``.  Three views of
"how much device memory does this cost":

1. **Captured plan** (:func:`memory_plan`): what a CUDA graph
   (``_graph.CapturedStep`` / ``CapturedFn``) holds, from the caching
   allocator's own counts taken around its capture — the counterpart of
   XLA's ``Compiled.memory_analysis()``.  ``peak_bytes`` reassembles from
   the components exactly as ``exporters.validate_memory_record`` checks.
2. **Analytic liveness** (:func:`graph_live_bytes`): the JAX package's
   last-use scan (``jaxpr_live_bytes``) over a
   ``torch.fx.experimental.proxy_tensor.make_fx`` graph — cheap, no
   device, good enough to catch a graph doubling its fp32 temp bytes
   under O2.
3. **Live gauges** (:func:`live_tensor_bytes` /
   :func:`record_live_arrays`): on the card the caching allocator's
   counts, on the CPU a census of live tensors (the counterpart of
   ``jax.live_arrays()``), folded into a :class:`MetricsRegistry` under
   the JAX package's gauge names.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from .exporters import MEMORY_PLAN_KEYS as MEMORY_PLAN_FIELDS

__all__ = ["memory_plan", "graph_live_bytes", "live_tensor_bytes",
           "live_array_bytes", "record_live_arrays",
           "device_memory_stats", "state_bytes", "MEMORY_PLAN_FIELDS"]


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def state_bytes(*state: Any) -> int:
    """Device bytes of the tensors of ``state``: tensors, nn.Modules
    (parameters and buffers), and objects or trees holding tensors in
    their attributes (an optimizer's masters and moments), each storage
    counted once."""
    seen: Dict[Any, int] = {}

    def visit(obj, depth):
        if isinstance(obj, torch.Tensor):
            key = (obj.device, obj.untyped_storage().data_ptr())
            seen[key] = max(seen.get(key, 0),
                            obj.untyped_storage().nbytes())
        elif isinstance(obj, torch.nn.Module):
            for t in list(obj.parameters()) + list(obj.buffers()):
                visit(t, depth)
        elif depth > 3 or obj is None or isinstance(
                obj, (str, bytes, int, float, bool)):
            return
        elif isinstance(obj, dict):
            for v in obj.values():
                visit(v, depth + 1)
        elif isinstance(obj, (list, tuple, set)):
            for v in obj:
                visit(v, depth + 1)
        elif hasattr(obj, "__dict__"):
            for v in vars(obj).values():
                visit(v, depth + 1)

    for s in state:
        visit(s, 0)
    return int(sum(seen.values()))


def memory_plan(captured, donated: Iterable[Any] = ()) -> Dict[str, int]:
    """The memory plan of a captured graph (a ``CapturedStep`` or a
    ``CapturedFn`` after its capture), from the allocator's counts taken
    around the capture:

    - ``argument_bytes``: the device bytes live when the capture began
      (the static inputs and the state, and whatever else was live:
      every tensor the graph can read);
    - ``output_bytes``: the static outputs (a ``CapturedStep``'s; a
      ``CapturedFn`` returns nothing) plus the ``donated`` state;
    - ``temp_bytes``: the graph's pool, measured (the bytes the allocator
      reserved for it during the capture), less the static outputs that
      live in it;
    - ``alias_bytes``: the ``donated`` state — the tensors the step
      updates in place (the model and the optimizer of a training step,
      an engine's caches), the counterpart of ``donate_argnums``: it is
      both an argument and an output, charged once;
    - ``generated_code_bytes``: 0 (a graph's kernels are the libraries'
      code, loaded once a process).

    ``peak_bytes`` = argument + output + temp + generated code − alias:
    the bytes live when the capture began plus the graph's pool.  A
    graph that shares a pool with graphs captured before it reports only
    what its own capture added.  Also returned: ``pool_bytes`` (the
    measured reservation) and ``donated_bytes``."""
    mem = getattr(captured, "memory", None)
    if getattr(captured, "graph", None) is None or not mem:
        raise ValueError("memory_plan needs a graph captured on the card "
                         "(call 2 of a CapturedStep or CapturedFn captures;"
                         " on the CPU nothing is captured)")
    donated_b = state_bytes(*donated)
    outs = getattr(captured, "static_out", None)
    from .._graph import leaves
    out_b = (sum(_nbytes(t) for t in leaves(outs))
             if outs is not None else 0)
    pool = max(int(mem["reserved_after"]) - int(mem["reserved_before"]),
               0)
    plan = {"argument_bytes": int(mem["allocated_before"]),
            "output_bytes": int(out_b + donated_b),
            "temp_bytes": int(max(pool - out_b, 0)),
            "alias_bytes": int(donated_b),
            "generated_code_bytes": 0}
    assert tuple(plan) == MEMORY_PLAN_FIELDS
    plan["peak_bytes"] = (plan["argument_bytes"] + plan["output_bytes"]
                          + plan["temp_bytes"]
                          + plan["generated_code_bytes"]
                          - plan["alias_bytes"])
    plan["pool_bytes"] = pool
    plan["donated_bytes"] = int(donated_b)
    return plan


# -- analytic liveness over an fx graph ------------------------------------

def _val_bytes(val) -> Dict[str, int]:
    """{dtype: bytes} of one node's value (a tensor, or a tuple of
    them)."""
    out: Dict[str, int] = {}
    vals = val if isinstance(val, (list, tuple)) else (val,)
    for v in vals:
        if isinstance(v, torch.Tensor):
            dt = str(v.dtype).replace("torch.", "")
            out[dt] = out.get(dt, 0) + _nbytes(v)
    return out


def graph_live_bytes(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Static peak-live-bytes estimate via a last-use scan — the JAX
    package's ``jaxpr_live_bytes`` over the aten graph that
    ``make_fx(fn)(*args)`` traces (``fn`` may also be a traced
    ``torch.fx.GraphModule`` whose nodes carry ``meta["val"]``).

    Walks the call nodes in program order: a node's outputs go live when
    it runs, operands die after their last use, outputs live to the end;
    a value nothing uses is dead (XLA would drop it) and never charged,
    and so is a node whose ``meta["aliases"]`` says its outputs lie in an
    input's storage (a view or an in-place operator of a recorded graph,
    ``analysis.graphs.Graph.fx``).
    Returns::

        {"peak_live_bytes": ...,        # args + peak temps
         "argument_bytes": ...,
         "peak_temp_bytes": ...,        # intermediates only
         "peak_temp_bytes_by_dtype": {"float32": ..., ...}}
    """
    if isinstance(fn, torch.fx.GraphModule):
        gm = fn
    else:
        from torch.fx.experimental.proxy_tensor import make_fx
        gm = make_fx(lambda *a: fn(*a, **kwargs))(*args)
    nodes = list(gm.graph.nodes)
    last_use: Dict[Any, int] = {}
    for i, node in enumerate(nodes):
        for a in node.all_input_nodes:
            last_use[a] = i
    end = len(nodes)
    for node in nodes:
        if node.op == "output":
            for a in node.all_input_nodes:
                last_use[a] = end          # outputs live to the end
    args_b = 0
    live = 0
    live_by: Dict[str, int] = {}
    peak = 0
    peak_by: Dict[str, int] = {}
    for i, node in enumerate(nodes):
        if node.op == "placeholder" or node.op == "get_attr":
            args_b += sum(_val_bytes(node.meta.get("val")).values())
            continue
        if node.op != "call_function":
            continue
        if node in last_use and not node.meta.get("aliases"):
            for dt, b in _val_bytes(node.meta.get("val")).items():
                live += b
                live_by[dt] = live_by.get(dt, 0) + b
        peak = max(peak, live)
        for dt, b in live_by.items():
            if b > peak_by.get(dt, 0):
                peak_by[dt] = b
        for a in set(node.all_input_nodes) | {node}:
            if (a.op != "call_function" or last_use.get(a) != i
                    or a.meta.get("aliases")):
                continue
            for dt, b in _val_bytes(a.meta.get("val")).items():
                live -= b
                live_by[dt] = live_by.get(dt, 0) - b
    return {"peak_live_bytes": int(args_b + peak),
            "argument_bytes": int(args_b),
            "peak_temp_bytes": int(peak),
            "peak_temp_bytes_by_dtype": {k: int(v)
                                         for k, v in peak_by.items()}}


# -- live device census ----------------------------------------------------

def _device(device) -> torch.device:
    """The package's device rule: the card unless the caller says
    ``"cpu"``."""
    return torch.device("cuda" if device is None else device)


def live_tensor_bytes(device=None) -> Dict[str, Any]:
    """Live tensor bytes and count on ``device`` (default: the card; the
    CPU when the caller passes ``"cpu"``).  On the card, the caching
    allocator's counts (``memory_allocated`` and its active blocks); on
    the CPU, a census of the live tensors the garbage collector tracks,
    each storage once.  Returns ``{"bytes", "arrays", "by_platform"}``, the
    JAX package's ``live_array_bytes`` shape."""
    dev = _device(device)
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        total = int(stats.get("allocated_bytes.all.current", 0))
        count = int(stats.get("active.all.current", 0))
        return {"bytes": total, "arrays": count,
                "by_platform": {"gpu": total}}
    storages: Dict[int, int] = {}
    count = 0
    for obj in gc.get_objects():
        if type(obj) in (torch.Tensor, torch.nn.Parameter) \
                and obj.device.type == "cpu" and not obj.is_meta:
            st = obj.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
            count += 1
    total = int(sum(storages.values()))
    return {"bytes": total, "arrays": count,
            "by_platform": {"cpu": total}}


# the JAX package's name for the census
live_array_bytes = live_tensor_bytes


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The card's allocator statistics — ``bytes_in_use`` (what the
    caching allocator holds from the device, graph pools included),
    ``bytes_limit`` (the card's memory) and ``peak_bytes_in_use`` — or
    None for ``device="cpu"``, which has none (callers read the census)."""
    dev = _device(device)
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev).total_memory),
            "peak_bytes_in_use": int(stats.get("reserved_bytes.all.peak",
                                               0))}


def record_live_arrays(registry=None, platform: Optional[str] = None,
                       device=None) -> Dict[str, Any]:
    """Fold the live census (and, on the card, the allocator's memory
    statistics) into gauges on ``registry`` (default process registry):
    ``device_live_bytes``, ``device_live_arrays``, and on the card
    ``device_bytes_in_use`` / ``device_bytes_limit``.  ``platform``
    (``"gpu"`` / ``"cpu"``) picks the device as the JAX package's
    argument does.  Returns the census dict, with ``memory_stats`` on
    the card."""
    from .metrics import get_registry
    reg = registry if registry is not None else get_registry()
    if device is None and platform is not None:
        device = "cuda" if platform == "gpu" else "cpu"
    census = live_tensor_bytes(device)
    reg.gauge("device_live_bytes",
              help="bytes of live tensors (the allocator's count on the "
                   "card, a census on the CPU)").set(census["bytes"])
    reg.gauge("device_live_arrays",
              help="count of live tensors").set(census["arrays"])
    hw = device_memory_stats(device)
    if hw:
        reg.gauge("device_bytes_in_use",
                  help="backend-reported bytes in use"
                  ).set(hw["bytes_in_use"])
        reg.gauge("device_bytes_limit",
                  help="backend-reported memory capacity"
                  ).set(hw["bytes_limit"])
        census["memory_stats"] = hw
    return census
