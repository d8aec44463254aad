"""Graph plumbing for the static analyzer: the aten graph of one call of a
step, its operator taxonomies, and the facts a trace cannot give.

Counterpart of ``apex_tpu/analysis/graphs.py``.  In JAX a graph is a
jaxpr and its lowered StableHLO.  In the port it is the aten graph of one
call of the entry point's step, recorded by :func:`trace_call` while the
call runs:

- every aten operator the call dispatches (forward, backward and
  optimizer), in program order, through a ``TorchDispatchMode``;
- every gloo or NCCL collective: the ``c10d`` operators reach the same
  dispatcher, each with its process group (its ranks) and reduce op,
  named by the JAX primitive it stands for (``allreduce_`` with SUM is a
  ``psum``, ``_allgather_base_`` an ``all_gather``, ``send`` a
  ``ppermute``, ...) and carrying its payload: the bytes it sends;
- every launch of a kernel wrapper of ``ops/`` as ONE node,
  ``kernel:<wrapper>``, with its operands' shapes, dtypes, strides and
  addresses (the counterpart of a ``pallas_call`` equation), through the
  ``ops._launches`` hook; the wrapper's plain version, which is what runs
  on the CPU, is hidden from the trace;
- every host synchronization, also those a CPU trace would not dispatch:
  ``Tensor.cpu`` / ``.tolist`` / ``.numpy`` / ``.item`` / ``bool(t)``,
  a ``Tensor.to`` whose destination is the CPU, and a ``Tensor.copy_``
  into a host buffer the call made (a factory with no device, or
  pinned) are caught at the Python level (a ``TorchFunctionMode``),
  because a copy of a CPU tensor to the CPU dispatches nothing (a read
  of a tensor made from host data with no device, ``torch.tensor(x)``,
  is host math on every device and is not one); on the card the
  dispatched copy to the CPU is caught below them as well; and
  ``torch.cuda.synchronize`` and ``Stream``/``Event.synchronize`` are
  caught by name for the call's duration.  Only the calling thread's
  syncs and launches are the call's: another thread's (a serving
  worker's, a server's) are not recorded.

The recording runs the call (on the CPU at a small size in the tests and
the CLI, on the card in ``chip_smoke.py``), so it sees what ran: no
dead-code elimination, unlike a jaxpr.  Beside the operators it records
the two facts a trace cannot give:

- each state tensor's storage address and version counter, before and
  after the call: the port's counterpart of donation (see
  ``rules.DonationRule``); a leaf that a kernel wrapper writes (one of
  its ``writes``, see ``ops._launches.priced``), or that a collective
  receives into, counts as written, since neither a ``ctypes`` launch
  nor a process group moves a version counter;
- with ``digests=True`` (the multi-rank traces), a digest of each state
  leaf before and after the call, which ``sharding`` compares across
  ranks.

:meth:`Graph.fx` rebuilds the recording as a ``torch.fx.GraphModule``
whose nodes carry ``meta["val"]`` (meta tensors), edges joined by tensor
identity, so ``observability.memory.graph_live_bytes`` scans it as it
scans a ``make_fx`` graph.  ``make_fx`` itself is not used: it cannot
keep a ``ctypes`` kernel as one node or trace a process group's
collectives.

Everything here is description, not judgement: the rules in
:mod:`.rules` decide.
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

__all__ = [
    "HOST_TRANSFER_PRIMS", "COLLECTIVE_PRIMS", "CONV_PRIMS", "DOT_PRIMS",
    "TensorMeta", "Node", "Trace", "LeafFact", "Graph", "trace_call",
    "walk_graph", "prim_nodes", "host_transfer_nodes", "conv_nodes",
    "large_dot_nodes", "transpose_nodes", "collective_nodes",
    "node_payload_bytes", "aliased_output_count", "donated_arg_names",
    "duplicate_donated_leaves", "state_leaves",
]

# operators that synchronize with the host: a value read back, an output
# whose shape depends on the data, a copy to the CPU, or a wait.  Any of
# these inside a captured step breaks its CUDA graph capture (and in an
# eager step is a per-step host round trip)
HOST_TRANSFER_PRIMS = frozenset({
    "_local_scalar_dense",          # .item(), bool(t), float(t), int(t)
    "is_nonzero", "equal",
    "nonzero", "nonzero_static", "masked_select", "unique",
    "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "cpu", "tolist", "numpy",       # copies to the host
    "synchronize",                  # torch.cuda / Stream / Event
})

# the JAX collective primitives the c10d operators map to (the names the
# comm plans and the expectation dicts speak)
COLLECTIVE_PRIMS = frozenset({
    "psum", "pmax", "pmin", "all_gather", "all_to_all",
    "reduce_scatter", "ppermute", "pgather", "broadcast",
})

CONV_PRIMS = frozenset({"convolution", "convolution_backward",
                        "_convolution", "cudnn_convolution",
                        "mkldnn_convolution"})
DOT_PRIMS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm",
                       "_scaled_mm"})
# kernel wrappers whose launch is matmul work (the JAX dense path's dots)
_DOT_KERNELS = frozenset({"kernel:flash_fwd", "kernel:flash_dq",
                          "kernel:flash_dkv"})

# copies that can change the memory order of their data
_COPY_PRIMS = frozenset({"clone", "_to_copy", "copy", "contiguous"})

# c10d operator -> (JAX primitive, index of the sent tensors, index of the
# received ones); allreduce's primitive follows its reduce op
_C10D = {
    "allreduce_": (None, 0, 0),
    "allreduce_coalesced_": (None, 0, 0),
    "_allgather_base_": ("all_gather", 1, 0),
    "allgather_": ("all_gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all_gather", 1, 0),
    "allgather_coalesced_": ("all_gather", 1, 0),
    "_reduce_scatter_base_": ("reduce_scatter", 1, 0),
    "reduce_scatter_": ("reduce_scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce_scatter", 1, 0),
    "alltoall_base_": ("all_to_all", 1, 0),
    "alltoall_": ("all_to_all", 1, 0),
    "broadcast_": ("broadcast", 0, 0),
    "send": ("ppermute", 0, None),
    "recv_": ("recv", None, 0),
    "recv_any_source_": ("recv", None, 0),
    "barrier": ("barrier", None, None),
    "monitored_barrier_": ("barrier", None, None),
}
# c10d RedOpType -> primitive (SUM, AVG, PRODUCT, MIN, MAX)
_REDUCE = {0: "psum", 1: "psum", 2: "pprod", 3: "pmin", 4: "pmax"}


# -- recorded values -------------------------------------------------------

def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


@dataclass(frozen=True)
class TensorMeta:
    """What the analysis keeps of one tensor an operator read or wrote."""
    shape: Tuple[int, ...]
    dtype: str
    stride: Tuple[int, ...]
    device: str
    ptr: int              # data_ptr: the first element's address
    storage: int          # the storage's base address
    offset: int           # storage offset, in elements
    itemsize: int

    @staticmethod
    def of(t: torch.Tensor) -> "TensorMeta":
        try:
            ptr = int(t.data_ptr())
            storage = int(t.untyped_storage().data_ptr())
        except (RuntimeError, NotImplementedError):   # no storage (meta)
            ptr = storage = 0
        return TensorMeta(tuple(int(s) for s in t.shape), _dt(t),
                          tuple(int(s) for s in t.stride()),
                          t.device.type, ptr, storage,
                          int(t.storage_offset()), int(t.element_size()))

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * self.itemsize

    @property
    def span(self) -> Tuple[int, int]:
        """The byte range ``[lo, hi)`` the tensor may touch."""
        if not self.numel:
            return (self.ptr, self.ptr)
        far = sum((s - 1) * st for s, st in zip(self.shape, self.stride)
                  if s > 1)
        return (self.ptr, self.ptr + (far + 1) * self.itemsize)

    def is_contiguous(self) -> bool:
        want = 1
        for s, st in reversed(list(zip(self.shape, self.stride))):
            if s != 1 and st != want:
                return False
            want *= s
        return True

    def order(self) -> Tuple[int, ...]:
        """The dimensions of size > 1, from the outermost in memory."""
        dims = [d for d, s in enumerate(self.shape) if s > 1]
        return tuple(sorted(dims, key=lambda d: -self.stride[d]))

    def fake(self) -> torch.Tensor:
        dtype = getattr(torch, self.dtype)
        return torch.empty_strided(self.shape, self.stride, dtype=dtype,
                                   device="meta")

    def __str__(self):
        return f"{self.dtype}{list(self.shape)}"


@dataclass
class Node:
    """One recorded operator call.  ``op`` is the full target
    (``aten.convolution.default``, ``c10d.allreduce_.default``,
    ``kernel:fused_adam``, ``host:cpu``); ``prim`` the taxonomy name the
    rules match (``convolution``, ``psum``, ``kernel:fused_adam``,
    ``cpu``); ``kind`` one of ``aten``, ``collective``, ``kernel``,
    ``host``.  A collective's ``inputs`` are the tensors it sends (its
    payload) and ``attrs`` its ``group`` (global ranks) and ``reduce``."""
    index: int
    op: str
    prim: str
    kind: str
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    in_keys: Tuple[int, ...] = ()
    out_keys: Tuple[int, ...] = ()
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def aliases(self) -> bool:
        """Every output lies in an input's storage (a view, an in-place
        operator): the node holds no bytes of its own."""
        ins = {m.storage for m in self.inputs}
        return bool(self.outputs) and all(m.storage in ins and m.storage
                                          for m in self.outputs)

    def describe(self) -> str:
        ins = ", ".join(str(m) for m in self.inputs)
        outs = ", ".join(str(m) for m in self.outputs)
        extra = ""
        if self.kind == "collective":
            extra = f" over {len(self.attrs.get('group', ()))} ranks"
        return f"{self.prim}({ins}) -> ({outs}){extra}"


@dataclass
class LeafFact:
    """One state leaf around the call: its name (``<arg>.<path>``), the
    argument it belongs to, its view before and after, its version
    counter before and after, and whether a kernel wrapper wrote it or a
    collective received into it (``kernel_operand``)."""
    name: str
    arg: str
    before: TensorMeta
    after: Optional[TensorMeta]
    version_before: int
    version_after: int
    kernel_operand: bool = False
    digest_before: Optional[str] = None
    digest_after: Optional[str] = None

    @property
    def rebound(self) -> bool:
        """The leaf lives at another address after the call (rebound, or
        its ``.data`` replaced): a captured graph keeps the old one."""
        return self.after is None or self.after.ptr != self.before.ptr \
            or self.after.storage != self.before.storage

    @property
    def written(self) -> bool:
        return self.version_after != self.version_before \
            or self.kernel_operand

    @property
    def in_place(self) -> bool:
        return self.written and not self.rebound


@dataclass
class Trace:
    """The picklable record of one call: the nodes, the state facts, the
    call's analytic cost, and what the builder noted (``info``: the
    world, the mesh axes, sharding claims, ...)."""
    nodes: List[Node]
    state: List[LeafFact]
    arg_names: Tuple[str, ...]
    output_keys: Tuple[int, ...]
    cost: Any = None
    info: Dict[str, Any] = field(default_factory=dict)


# -- the recorder ----------------------------------------------------------

def flat_tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            out.extend(flat_tensors(v))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out.extend(flat_tensors(v))
    return out


def _short(func) -> str:
    packet = getattr(func, "overloadpacket", None)
    return packet.__name__ if packet is not None else str(func)


def _namespace(func) -> str:
    return getattr(func, "namespace", "") or str(func).split(".")[0]


class _Recorder:
    """What one :func:`trace_call` accumulates."""

    def __init__(self):
        self.nodes: List[Node] = []
        # the thread that runs the call: syncs and launches of other
        # threads (a serving worker, a server) are not the step's
        self.thread = threading.get_ident()
        self.lock = threading.Lock()
        self.hide_depth: Dict[int, int] = {}
        self.keys = WeakIdKeyDictionary()
        self.next_key = 0
        self.kernel_ptrs: List[Tuple[int, int]] = []
        # tensors made from host data with no device: their reads are host
        # math on every device, not a sync
        self.host_born = WeakIdKeyDictionary()
        # host buffers the call made (a factory with no device, or pinned):
        # a copy into one from a device tensor is a copy to the CPU
        self.host_buffers = WeakIdKeyDictionary()
        # the devices the call read off its tensors (``x.device``): a
        # ``.to`` one of them names the step's own device, which on a CPU
        # trace is the CPU too, and not the host (by id; kept alive here)
        self.step_devices: Dict[int, torch.device] = {}

    def key(self, t: torch.Tensor) -> int:
        k = self.keys.get(t)
        if k is None:
            k = self.next_key
            self.next_key += 1
            self.keys[t] = k
        return k

    @contextlib.contextmanager
    def hidden(self):
        tid = threading.get_ident()
        with self.lock:
            self.hide_depth[tid] = self.hide_depth.get(tid, 0) + 1
        try:
            yield
        finally:
            with self.lock:
                self.hide_depth[tid] -= 1

    def is_hidden(self) -> bool:
        return self.hide_depth.get(threading.get_ident(), 0) > 0

    def records_here(self) -> bool:
        """This thread is the call's own, and not inside a hidden span."""
        return threading.get_ident() == self.thread and not self.is_hidden()

    def add(self, op, prim, kind, ins, outs, attrs=None) -> None:
        if prim in HOST_TRANSFER_PRIMS:
            attrs = dict(attrs or {}, where=_caller())
        ins = [t for t in ins if isinstance(t, torch.Tensor)]
        outs = [t for t in outs if isinstance(t, torch.Tensor)]
        with self.lock:
            node = Node(len(self.nodes), op, prim, kind,
                        tuple(TensorMeta.of(t) for t in ins),
                        tuple(TensorMeta.of(t) for t in outs),
                        tuple(self.key(t) for t in ins),
                        tuple(self.key(t) for t in outs),
                        dict(attrs or {}))
            self.nodes.append(node)

    # -- aten and c10d operators
    def dispatch(self, func, args, kwargs, out) -> None:
        ins = flat_tensors(args) + flat_tensors(kwargs)
        outs = flat_tensors(out)
        if all(t.device.type == "meta" for t in ins + outs):
            return            # a cost count pricing a kernel on meta copies
        ns, name = _namespace(func), _short(func)
        if ns == "c10d" and name in _C10D:
            prim, src, dst = _C10D[name]
            attrs: Dict[str, Any] = {}
            for a in args:
                ranks = _group_ranks(a)
                if ranks is not None:
                    attrs["group"] = ranks
                    continue
                red = _reduce_op(a)
                if red is not None:
                    attrs["reduce"] = red
            if prim is None:
                prim = _REDUCE.get(attrs.get("reduce", 0), "psum")
            sent = flat_tensors(args[src]) if src is not None else []
            got = flat_tensors(args[dst]) if dst is not None else []
            self.add(str(func), prim, "collective", sent, got, attrs)
            with self.lock:
                # a process group writes its output without moving the
                # tensor's version counter
                self.kernel_ptrs.extend(TensorMeta.of(t).span for t in got)
            return
        if name in ("_to_copy", "copy_") and _to_host(name, ins, outs):
            self.add(str(func), "cpu", "host", ins, outs)
            return
        attrs = {}
        if name in ("permute", "transpose", "t", "movedim"):
            attrs["dims"] = [a for a in args[1:] if not isinstance(
                a, torch.Tensor)]
        self.add(str(func), name.rstrip("_") if name.endswith("_")
                 and not name.endswith("__") else name, "aten", ins, outs,
                 attrs)


def _caller() -> str:
    """``file:line`` of the innermost frame of the traced program (not of
    torch or of this package): where a host sync was made."""
    import os
    import traceback
    here = os.path.dirname(os.path.abspath(__file__))
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    for fr in reversed(traceback.extract_stack()[:-3]):
        f = os.path.abspath(fr.filename)
        if not f.startswith(here) and not f.startswith(torch_dir) \
                and "contextlib" not in f:
            return f"{os.path.basename(f)}:{fr.lineno}"
    return "?"


def _group_ranks(obj) -> Optional[Tuple[int, ...]]:
    """The global ranks of a ``c10d.ProcessGroup`` script object."""
    if type(obj).__name__ != "ScriptObject":
        return None
    import torch.distributed as dist
    try:
        pg = dist.ProcessGroup.unbox(obj)
    except Exception:  # noqa: BLE001 - another script object (a ReduceOp)
        return None
    try:
        return tuple(dist.get_process_group_ranks(pg))
    except Exception:  # noqa: BLE001 - a group this rank is not in
        return tuple(range(pg.size()))


def _reduce_op(obj) -> Optional[int]:
    if type(obj).__name__ != "ScriptObject":
        return None
    try:
        return int(obj.op())
    except Exception:  # noqa: BLE001 - not a ReduceOp
        return None


def _to_host(name, ins, outs) -> bool:
    """A copy whose destination is on the CPU and whose source is not."""
    if name == "_to_copy":
        src, dst = ins[:1], outs[:1]
    else:
        dst, src = ins[:1], ins[1:2]
    return bool(src and dst) and dst[0].device.type == "cpu" \
        and src[0].device.type not in ("cpu", "meta")


_ACTIVE: List[_Recorder] = []
_ACTIVE_LOCK = threading.Lock()


def _make_modes(rec: _Recorder):
    """The dispatch mode (operators) and the function mode (host reads a
    CPU trace would not dispatch) of one recording."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class RecordMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not rec.is_hidden():
                rec.dispatch(func, args, kwargs, out)
            return out

    host = {"cpu": "cpu", "tolist": "tolist", "numpy": "numpy",
            "item": "_local_scalar_dense", "__bool__": "_local_scalar_dense",
            "__float__": "_local_scalar_dense",
            "__int__": "_local_scalar_dense",
            "__index__": "_local_scalar_dense"}

    factories = (torch.tensor, torch.as_tensor, torch.scalar_tensor,
                 torch.from_numpy)
    # buffer factories: a buffer made with no device, or pinned, is a host
    # buffer on every device
    buffers = (torch.empty, torch.zeros, torch.ones, torch.full,
               torch.empty_strided)

    device_of = torch.Tensor.device          # the descriptor itself

    def to_host(func, name, args, kwargs) -> Optional[torch.Tensor]:
        """The source of a ``Tensor.to`` whose destination is the host (the
        CPU, named otherwise than by a device read off the call's
        tensors), or of a ``Tensor.copy_`` into a host buffer of the
        call's; else None.  On a CPU trace neither moves data, so the
        dispatch below cannot see them."""
        if name == "to" and func is torch.Tensor.to:
            try:
                dev = torch._C._nn._parse_to(*args[1:], **kwargs)[0]
            except (TypeError, RuntimeError):
                return None
            if dev is None or dev.type != "cpu":
                return None
            given = kwargs.get("device", args[1] if len(args) > 1
                               else None)
            if isinstance(given, torch.Tensor):     # .to(other)
                return args[0] if given in rec.host_buffers else None
            if id(given) in rec.step_devices:
                return None
            return args[0]
        if name == "copy_" and func is torch.Tensor.copy_ \
                and len(args) > 1 and isinstance(args[1], torch.Tensor) \
                and args[0] in rec.host_buffers:
            return args[1]
        return None

    class HostMode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in factories or func in buffers:
                out = func(*args, **kwargs)
                dev = kwargs.get("device")
                if func in factories and (
                        dev is None or torch.device(dev).type == "cpu"):
                    rec.host_born[out] = True
                if func in buffers and (dev is None
                                        or kwargs.get("pin_memory")):
                    rec.host_buffers[out] = True
                return out
            if rec.is_hidden() or not args \
                    or not isinstance(args[0], torch.Tensor):
                return func(*args, **kwargs)
            name = getattr(func, "__name__", "")
            if name == "__get__" and getattr(func, "__self__",
                                             None) is device_of:
                out = func(*args, **kwargs)
                rec.step_devices[id(out)] = out
                return out
            prim, src = host.get(name), args[0]
            if prim is not None and getattr(torch.Tensor, name,
                                            None) is not func:
                prim = None
            if prim is None:
                src = to_host(func, name, args, kwargs)
                if src is None:
                    return func(*args, **kwargs)
                prim = "cpu"
            if src in rec.host_born:
                with rec.hidden():
                    return func(*args, **kwargs)
            with rec.hidden():
                out = func(*args, **kwargs)
            rec.add(f"host:{name}", prim, "host", [src], flat_tensors(out))
            return out

    return RecordMode(), HostMode()


def _kernel_hook(wrapper, body, cost, args, kwargs):
    """The ``ops._launches`` hook of the recordings running: the launch as
    one ``kernel:<wrapper>`` node, its own operators hidden.  The operands
    it writes are the wrapper's ``writes``: a ``ctypes`` launch moves no
    version counter."""
    with _ACTIVE_LOCK:
        recs = [r for r in _ACTIVE if r.records_here()]
    ins = flat_tensors(list(args)) + flat_tensors(kwargs)
    if not recs or all(t.device.type == "meta" for t in ins):
        return body(*args, **kwargs)
    with contextlib.ExitStack() as stack:
        for r in recs:
            stack.enter_context(r.hidden())
        out = body(*args, **kwargs)
    outs = flat_tensors(out)
    bound = inspect.signature(wrapper).bind(*args, **kwargs).arguments
    written = [k for k in wrapper.writes
               if isinstance(bound.get(k), torch.Tensor)]
    spans = [TensorMeta.of(bound[k]).span for k in written]
    for r in recs:
        r.add(f"kernel:{wrapper.__name__}", f"kernel:{wrapper.__name__}",
              "kernel", ins, outs, {"written": written})
        with r.lock:
            r.kernel_ptrs.extend(spans)
    return out


@contextlib.contextmanager
def _sync_patched(rec: _Recorder):
    """``torch.cuda.synchronize`` and ``Stream``/``Event.synchronize``
    recorded as host nodes for the call (run through on the card)."""
    cuda = torch.cuda
    saved = [(cuda, "synchronize", cuda.synchronize),
             (cuda.Stream, "synchronize", cuda.Stream.synchronize),
             (cuda.Event, "synchronize", cuda.Event.synchronize)]

    def wrap(orig, what):
        def sync(*a, **kw):
            if rec.records_here():
                rec.add(f"host:{what}", "synchronize", "host", [], [])
            if cuda.is_available():
                return orig(*a, **kw)
            return None
        return sync

    for obj, name, orig in saved:
        setattr(obj, name, wrap(orig, f"{getattr(obj, '__name__', 'cuda')}."
                                      f"{name}"))
    try:
        yield
    finally:
        for obj, name, orig in saved:
            setattr(obj, name, orig)


def state_leaves(state: Dict[str, Any]) -> List[Tuple[str, str,
                                                        torch.Tensor]]:
    """``(name, arg, tensor)`` of every tensor of ``state`` (a dict of
    argument name -> nested dicts, lists and tuples of tensors), named
    ``<arg>.<path>``."""
    out: List[Tuple[str, str, torch.Tensor]] = []

    def visit(obj, path, arg):
        if isinstance(obj, torch.Tensor):
            out.append((path, arg, obj))
        elif isinstance(obj, dict):
            for k, v in obj.items():
                visit(v, f"{path}.{k}", arg)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                visit(v, f"{path}.{i}", arg)

    for arg, tree in state.items():
        visit(tree, arg, arg)
    return out


def _digest(t: torch.Tensor) -> str:
    b = t.detach().reshape(-1).contiguous().cpu()
    if b.dtype == torch.bool:
        b = b.to(torch.uint8)
    return hashlib.sha1(b.view(torch.uint8).numpy().tobytes()).hexdigest()


def trace_call(fn: Callable, *args, state: Optional[Callable[[], Dict[
        str, Any]]] = None, cost: bool = True, digests: bool = False,
               info: Optional[Dict[str, Any]] = None,
               **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once and record it (see the module doc).

    ``state()`` returns the step's state as ``{argument name: tree}``; it
    is called before and after the call, so a leaf rebound by the call
    shows at its new address.  ``cost`` prices the same call with
    ``observability.costmodel.count_cost``; ``digests`` digests each
    state leaf before and after (the sharding rule's run-time check).
    Returns the picklable :class:`Trace`."""
    from ..ops import _launches
    rec = _Recorder()
    before = state_leaves(state()) if state is not None else []
    facts0 = [(name, arg, TensorMeta.of(t), t._version,
               _digest(t) if digests else None)
              for name, arg, t in before]
    result: List[Any] = []

    def run():
        result.append(fn(*args, **kwargs))

    dmode, fmode = _make_modes(rec)
    with _ACTIVE_LOCK:
        _ACTIVE.append(rec)
        if len(_ACTIVE) == 1:
            _launches.add_hook(_kernel_hook)
    try:
        with _sync_patched(rec), fmode, dmode:
            if cost:
                from ..observability import costmodel
                c = costmodel.count_cost(run)
            else:
                c = None
                run()
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE.remove(rec)
            if not _ACTIVE:
                _launches.remove_hook(_kernel_hook)
    after = {name: t for name, _, t in (state_leaves(state())
                                        if state is not None else [])}
    spans = rec.kernel_ptrs
    facts = []
    for name, arg, meta, ver, dg in facts0:
        t = after.get(name)
        lo, hi = meta.span
        facts.append(LeafFact(
            name, arg, meta, None if t is None else TensorMeta.of(t), ver,
            -1 if t is None else t._version,
            any(a < hi and lo < b for a, b in spans) if hi > lo else False,
            dg, _digest(t) if digests and t is not None else None))
    returned = flat_tensors(result[0]) if result else []
    out_keys = [rec.keys[t] for t in returned if t in rec.keys]
    for t in after.values():
        if t in rec.keys:
            out_keys.append(rec.keys[t])
    info = dict(info or {})
    info["returned_bytes"] = sum(TensorMeta.of(t).nbytes for t in returned)
    return Trace(rec.nodes, facts,
                 tuple(state().keys()) if state is not None else (),
                 tuple(dict.fromkeys(out_keys)), c, info)


# -- walkers ---------------------------------------------------------------

def walk_graph(graph) -> Iterator[Node]:
    """Every node of a graph (a :class:`Graph` or a :class:`Trace`), in
    program order."""
    trace = graph.trace if isinstance(graph, Graph) else graph
    return iter(trace.nodes)


def prim_nodes(graph, names: Iterable[str]) -> List[Node]:
    names = frozenset(names)
    return [n for n in walk_graph(graph) if n.prim in names]


def host_transfer_nodes(graph) -> List[Node]:
    return prim_nodes(graph, HOST_TRANSFER_PRIMS)


def conv_nodes(graph) -> List[Node]:
    return [n for n in walk_graph(graph)
            if n.prim in CONV_PRIMS and n.kind == "aten"]


def _dot_operands(n: Node) -> Sequence[TensorMeta]:
    if n.kind == "kernel":
        return n.inputs[:3]             # q, k, v (and dO after them)
    if n.prim in ("addmm", "baddbmm", "addbmm"):
        return n.inputs[1:3]            # the bias is an add
    return n.inputs[:2]


def large_dot_nodes(graph, min_elems: int = 256) -> List[Node]:
    """Matmul nodes whose matrix operands are all activation/param sized
    (>= ``min_elems`` elements), the flash kernels among them; tiny
    bookkeeping products are exempt from dtype policy.  A node's operand
    dtypes are :func:`dot_dtypes`."""
    return [n for n in walk_graph(graph)
            if (n.prim in DOT_PRIMS or n.prim in _DOT_KERNELS)
            and all(m.numel >= min_elems for m in _dot_operands(n))]


def dot_dtypes(n: Node) -> Tuple[str, ...]:
    return tuple(m.dtype for m in _dot_operands(n))


def transpose_nodes(graph, min_elems: int = 0) -> List[Node]:
    """Relayouts: copies whose output lies in another dimension order
    than their input (a ``clone``/``contiguous``/``_to_copy``/``copy_`` of
    a permuted view).  A permute alone is a free view in PyTorch; the
    copy that materializes it is the transpose."""
    out = []
    for n in walk_graph(graph):
        if n.prim not in _COPY_PRIMS or n.kind != "aten":
            continue
        if n.prim == "copy":
            src = n.inputs[1:2]
            dst = n.inputs[:1]
        else:
            src, dst = n.inputs[:1], n.outputs[:1]
        if not (src and dst) or src[0].numel < max(min_elems, 2):
            continue
        if src[0].shape == dst[0].shape and src[0].order() != dst[0].order():
            out.append(n)
    return out


def in_state(graph, meta: TensorMeta) -> bool:
    """``meta`` lies inside a state leaf or has a state leaf's shape (a
    parameter, or its gradient): a relayout of it is a weight's, not an
    activation's."""
    trace = graph.trace if isinstance(graph, Graph) else graph
    lo, hi = meta.span
    return any((f.before.span[0] <= lo and hi <= f.before.span[1])
               or f.before.shape == meta.shape
               for f in trace.state if f.before.numel)


def transpose_permutation(n: Node) -> List[int]:
    src = n.inputs[1] if n.prim == "copy" else n.inputs[0]
    dst = n.inputs[0] if n.prim == "copy" else n.outputs[0]
    where = {d: i for i, d in enumerate(dst.order())}
    return [where.get(d, d) for d in src.order()]


def collective_nodes(graph) -> List[Node]:
    return [n for n in walk_graph(graph)
            if n.kind == "collective" and n.prim in COLLECTIVE_PRIMS]


def node_payload_bytes(n: Node) -> int:
    """Bytes of operand data a node moves (sum over its inputs): for a
    collective, the tensors it sends, its on-wire payload of one rank."""
    return sum(m.nbytes for m in n.inputs)


# -- donation --------------------------------------------------------------

def aliased_output_count(graph) -> int:
    """Number of state leaves the call updated in place (written, at the
    same address): the port's count of donations honoured."""
    trace = graph.trace if isinstance(graph, Graph) else graph
    return sum(1 for f in trace.state if f.in_place)


def donated_arg_names(graph) -> Tuple[List[str], List[str]]:
    """``(donated, partial)``: the state arguments with at least one leaf
    updated in place, and those of them with a leaf that was rebound or
    written off its address (a donation hole inside one argument)."""
    trace = graph.trace if isinstance(graph, Graph) else graph
    by: Dict[str, List[LeafFact]] = {}
    for f in trace.state:
        by.setdefault(f.arg, []).append(f)
    donated, partial = [], []
    for arg in trace.arg_names:
        leaves = by.get(arg, [])
        if any(f.in_place for f in leaves):
            donated.append(arg)
            if any(f.rebound for f in leaves):
                partial.append(arg)
    return donated, partial


def duplicate_donated_leaves(graph) -> List[str]:
    """Written state leaves that are the same buffer as another written
    leaf: the same tensor under two names, or two views whose bytes
    overlap without one holding the other (a view of a flat buffer inside
    it is a layout, not a duplicate).  The port's double donation: one
    buffer that two logically distinct pieces of state both write (a
    cache init that shares one zeros buffer across layers)."""
    trace = graph.trace if isinstance(graph, Graph) else graph
    leaves = [f for f in trace.state if f.written and f.before.numel]
    dups = []
    seen: Dict[Tuple[int, int, Tuple[int, ...]], str] = {}
    for f in leaves:
        key = (f.before.ptr, f.before.nbytes, f.before.shape)
        if key in seen:
            dups.append(f"{f.name} shares a buffer with {seen[key]}")
            continue
        seen[key] = f.name
    spans = sorted(((f.before.span, f.name) for f in leaves))
    for i, ((lo, hi), name) in enumerate(spans):
        for (lo2, hi2), name2 in spans[i + 1:]:
            if lo2 >= hi:
                break
            contains = (lo <= lo2 and hi2 <= hi) or (lo2 <= lo and hi <= hi2)
            if not contains:
                dups.append(f"{name2} overlaps {name} without lying "
                            f"inside it")
    return dups


# -- the graph -------------------------------------------------------------

_STUBS: Dict[str, Callable] = {}


def _target(n: Node):
    """The fx target of a node: the aten / c10d operator itself, or a named
    stub for a kernel launch or a host read."""
    if n.kind in ("aten", "collective") and n.op.count(".") >= 2:
        ns, name, overload = n.op.split(".", 2)
        try:
            return getattr(getattr(getattr(torch.ops, ns), name), overload)
        except AttributeError:
            pass
    stub = _STUBS.get(n.op)
    if stub is None:
        def stub(*args):
            raise RuntimeError(f"{n.op} is a recorded node, not callable")
        stub.__name__ = n.op.replace(":", "_").replace(".", "_")
        _STUBS[n.op] = stub
    return stub


def to_fx(trace: Trace) -> torch.fx.GraphModule:
    """The recording as a ``torch.fx.GraphModule``: a placeholder per
    tensor the call read before making it, a call node per recorded node
    (``meta["val"]`` its outputs as meta tensors, ``meta["aliases"]``
    whether they lie in an input's storage), the outputs the returned
    and state tensors."""
    g = torch.fx.Graph()
    env: Dict[int, torch.fx.Node] = {}
    for n in trace.nodes:
        args = []
        for meta, key in zip(n.inputs, n.in_keys):
            if key not in env:
                ph = g.placeholder(f"arg{len(env)}")
                ph.meta["val"] = meta.fake()
                env[key] = ph
            args.append(env[key])
        node = g.call_function(_target(n), tuple(args))
        vals = tuple(m.fake() for m in n.outputs)
        node.meta["val"] = vals[0] if len(vals) == 1 else vals
        node.meta["aliases"] = n.aliases
        node.meta["prim"] = n.prim
        for key in n.out_keys:
            env[key] = node
    g.output(tuple(env[k] for k in trace.output_keys if k in env))
    return torch.fx.GraphModule(torch.nn.Module(), g)


def text(trace: Trace) -> str:
    """The call as text, one node a line (prim, operands, results; no
    address): what the JAX package compares as ``str(jaxpr)``."""
    return "\n".join(n.describe() for n in trace.nodes)


class Graph:
    """One traced entry point: the recording of one call of its step
    (``trace()`` runs lazily, once), or an already recorded
    :class:`Trace` (``recorded=``, what the gloo ranks send back)."""

    def __init__(self, trace: Optional[Callable[[], Trace]] = None,
                 recorded: Optional[Trace] = None):
        self._trace = trace
        self._recorded = recorded
        self._fx = None

    @property
    def trace(self) -> Trace:
        if self._recorded is None:
            if self._trace is None:
                raise ValueError("entry point has no tracer")
            self._recorded = self._trace()
        return self._recorded

    @property
    def nodes(self) -> List[Node]:
        return self.trace.nodes

    @property
    def state(self) -> List[LeafFact]:
        return self.trace.state

    @property
    def arg_names(self) -> Tuple[str, ...]:
        return self.trace.arg_names

    @property
    def cost(self):
        return self.trace.cost

    @property
    def info(self) -> Dict[str, Any]:
        return self.trace.info

    @property
    def text(self) -> str:
        return text(self.trace)

    def fx(self) -> torch.fx.GraphModule:
        if self._fx is None:
            self._fx = to_fx(self.trace)
        return self._fx
