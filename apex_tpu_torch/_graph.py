"""A training step captured whole in a CUDA graph and replayed: the
mechanics behind ``parallel.make_step``.

The JAX package compiles its step with ``jax.jit`` (over ``shard_map``,
with ``steps_per_call`` as a ``lax.scan``); the port's counterpart is a
``torch.cuda.CUDAGraph`` of the step, captured once and replayed.  A
:class:`CapturedStep` runs the step function ``K`` times a call and
keeps call ``i`` exactly step ``i``:

- call 1 runs the steps eagerly on a side stream.  It is the warm-up:
  every kernel library is built and loaded there (``ops._build``), the
  NCCL communicator is created by the first collective, the lazy tables
  (LAMB's chunk table) are made, and cuBLAS and cuDNN pick their kernels;
  none of which may happen inside a capture;
- call 2 copies the batch into static buffers, captures the ``K`` steps
  into one graph in a private memory pool, and replays it once;
- every later call copies its batch into the static buffers and replays.

Every call returns copies of the step's outputs, which the next call
leaves alone.  A graph is shape-static: a batch of other shapes or dtypes
is refused, naming the culprit argument as the compilation ledger's
retrace differ names it.

The compilation ledger (``observability.compilation``): a step or a
function instrumented under an entry label (``instrument``) records its
capture there, timed, as the JAX package records a jit trace; on the CPU,
or eagerly, its first call.  A refused batch is recorded through the
differ before the ``ValueError``.

A capture that fails raises; nothing falls back to the eager step.  The
step may only touch state in place (the amp optimizer, its scalers and
``last_info``, the moments, BatchNorm's running statistics all are):
state that is rebound instead would freeze at its capture-time address.

Random numbers: the default CUDA generator is the graph's own; every
other CUDA generator the step draws from (BERT's dropout generator, from
which the flash kernels' seeds come) is registered with the graph, so
each replay advances its offset as an eager step does and draws new
numbers.  Kernel launch counts (``ops.launch_counts``) count on the host
at launch: the capture's launches are taken back and each replay adds
them again, so the counts stay those of the steps that ran.

:class:`CapturedFn` is the same mechanics for a function of no arguments
over state it already holds in static tensors, which it reads and writes
in place: a serving engine's decode window and admission.  Several of
them may share one memory pool (``pool``): the function keeps nothing it
allocates, so a pool holds only scratch, and graphs that share it run
one after another on one stream.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from . import ops
from .utils.profiler import launch_guard

__all__ = ["CapturedStep", "CapturedFn", "run_steps", "tree_map",
           "leaves", "cuda_generators"]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the tensors of a tensor, tuple, list or dict."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if tree is None:
        return None
    raise TypeError(f"a step's batch and outputs are tensors, or tuples, "
                    f"lists or dicts of them; got {type(tree).__name__}")


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree, in order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _stack(outs: List[Any]) -> Any:
    """K outputs of one structure as one, each tensor stacked on a new
    leading axis (the ``lax.scan`` output)."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([o[i] for o in outs])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if first is None:
        return None
    raise TypeError(f"a step's outputs are tensors, or tuples, lists or "
                    f"dicts of them; got {type(first).__name__}")


def run_steps(step_fn: Callable, batch: Any, steps_per_call: int) -> Any:
    """``step_fn(batch)``, or with ``steps_per_call`` K > 1 ``step_fn`` on
    each of the K micro-batches of ``batch`` (every tensor shaped ``(K,
    per_step...)``), its outputs stacked on a leading K axis."""
    K = int(steps_per_call)
    if K == 1:
        return step_fn(batch)
    lead = {t.shape[0] if t.dim() else None for t in leaves(batch)}
    if lead != {K}:
        raise ValueError(f"steps_per_call={K} needs every batch tensor "
                         f"shaped (K, per_step...); got leading dims "
                         f"{sorted(lead, key=str)}")
    return _stack([step_fn(tree_map(lambda t, k=k: t[k], batch))
                   for k in range(K)])


def cuda_generators(module: torch.nn.Module) -> List[torch.Generator]:
    """The CUDA generators that ``module``'s submodules hold as attributes
    (BERT's dropout generator), each once."""
    found: Dict[int, torch.Generator] = {}
    for m in module.modules():
        for v in vars(m).values():
            if (isinstance(v, torch.Generator) and v.device.type == "cuda"):
                found.setdefault(id(v), v)
    return list(found.values())


class CapturedStep:
    """``train(batch)`` over ``step_fn`` on a CUDA device: call 1 eager
    (the warm-up), call 2 captures, every call from 2 on replays (see the
    module doc).  ``generators``: the CUDA generators other than the
    default that the step draws from."""

    def __init__(self, step_fn: Callable, steps_per_call: int,
                 device: torch.device,
                 generators: Iterable[torch.Generator] = ()):
        self.step_fn = step_fn
        self.steps_per_call = int(steps_per_call)
        self.device = torch.device(device)
        self.generators = list(generators)
        self.calls = 0
        self.replays = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_batch = None
        self.static_out = None
        # the kernel launches of one replay, recorded at capture
        self.launches: Dict[str, int] = {}
        # the allocator's counts around the capture (memory.memory_plan)
        self.memory: Dict[str, int] = {}
        # the compilation ledger's closure (``instrument``) and the
        # signature the graph was captured at
        self.closure = None
        self.signature: Optional[Dict[str, Any]] = None

    def instrument(self, closure) -> None:
        """Record the capture in the ledger under ``closure`` (an
        ``observability.compilation.Closure``)."""
        self.closure = closure

    def _run(self, batch: Any) -> Any:
        return run_steps(self.step_fn, batch, self.steps_per_call)

    def __call__(self, batch: Any) -> Any:
        with launch_guard():
            batch = tree_map(self._on_device, batch)
            if self.calls == 0:
                out = self._warm_up(batch)
            else:
                if self.graph is None:
                    self._capture(batch)
                else:
                    self._feed(batch)
                self.graph.replay()
                ops.add_launches(self.launches)
                self.replays += 1
                # the graph's outputs are overwritten by the next replay
                out = tree_map(torch.clone, self.static_out)
            self.calls += 1
            return out

    def _on_device(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cuda":
            return t
        return t.to(self.device, non_blocking=t.is_pinned())

    def _warm_up(self, batch: Any) -> Any:
        # copies, as a replay returns: the step's own tensors (the
        # optimizer's last_info, say) are rewritten by the next call
        return _on_side_stream(
            lambda: tree_map(torch.clone, self._run(batch)), self.device)

    def _feed(self, batch: Any) -> None:
        new, static = leaves(batch), leaves(self.static_batch)
        if len(new) != len(static) or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(new, static)):
            from .observability import compilation
            sig = _batch_signature(batch)
            if self.closure is not None:
                culprits = self.closure.refuse(sig)
            else:
                culprits = compilation.diff_signatures(self.signature, sig)
            raise ValueError(
                "a captured step takes batches of the shapes and dtypes it "
                "was captured with; "
                f"{compilation.culprit_text(culprits)}")
        for s, b in zip(static, new):
            s.copy_(b, non_blocking=True)

    def _capture(self, batch: Any) -> None:
        self.static_batch = tree_map(torch.clone, batch)
        self.signature = _batch_signature(batch)
        out: List[Any] = []
        t0 = time.perf_counter()
        # a private memory pool (the default of torch.cuda.graph)
        self.graph, self.launches, self.memory = _capture(
            lambda: out.append(self._run(self.static_batch)),
            self.generators)
        self.static_out = out[0]
        if self.closure is not None:
            self.closure.record(self.signature, time.perf_counter() - t0)


def _batch_signature(batch: Any) -> Dict[str, Any]:
    """A step's abstract signature: its one argument, the batch."""
    from .observability import compilation
    return compilation.abstract_signature((batch,), arg_names=("batch",))


def _on_side_stream(fn: Callable, device: torch.device) -> Any:
    """``fn()`` on a side stream that waits for the current one and that
    the current one then waits for: a capture's warm-up."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    for t in leaves(out) if out is not None else ():
        if t.is_cuda:
            t.record_stream(cur)      # made on the side stream, used on cur
    return out


def _capture(fn: Callable, generators: Iterable[torch.Generator] = (),
             pool=None):
    """``fn()`` captured into a new CUDA graph (in ``pool``, else a
    private one), the CUDA generators registered; returns the graph, the
    kernel launches of one replay and the allocator's counts around the
    capture (``allocated_before``, ``reserved_before``,
    ``reserved_after``: what ``observability.memory.memory_plan``
    reads).  The capture's own launches are taken back from the
    counts."""
    graph = torch.cuda.CUDAGraph()
    generators = list(generators)
    if generators:
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                f"this torch ({torch.__version__}) has no "
                f"CUDAGraph.register_generator_state: a captured step "
                f"would replay one dropout mask from its "
                f"{len(generators)} CUDA generator(s)")
        for g in generators:
            graph.register_generator_state(g)
    before = ops.launch_counts()
    # torch.cuda.graph releases the allocator's cache before it captures:
    # release it first, so the reservation around the capture is the pool's
    torch.cuda.empty_cache()
    dev = torch.cuda.current_device()
    mem = {"allocated_before": torch.cuda.memory_allocated(dev),
           "reserved_before": torch.cuda.memory_reserved(dev)}
    # no garbage collection during the capture: a collection may free a
    # dead cycle holding another CUDA graph, and destroying a graph while a
    # stream captures invalidates the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        with launch_guard(), torch.cuda.graph(graph, pool=pool):
            fn()
    finally:
        if collecting:
            gc.enable()
        after = ops.launch_counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        # a capture launches nothing: its counts come back with each
        # replay
        ops.add_launches(launches, -1)
    mem["reserved_after"] = torch.cuda.memory_reserved(dev)
    return graph, launches, mem


class CapturedFn:
    """``fn()`` over static tensors it updates in place.  On the CPU every
    call runs it.  On a CUDA device call 1 runs it on a side stream (the
    warm-up), call 2 captures it into a graph (in ``pool``, a
    ``torch.cuda.graph_pool_handle()``, else a private pool) and replays,
    later calls replay.  ``eager=True`` runs every call, as on the CPU."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.eager = False
        self.calls = 0
        self.replays = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.memory: Dict[str, int] = {}
        self.closure = None

    def instrument(self, closure) -> None:
        """Record the capture (on the CPU or eagerly, the first call) in
        the ledger under ``closure`` (an
        ``observability.compilation.Closure``), at the empty signature: the
        function takes no arguments."""
        self.closure = closure

    def _timed(self, fn: Callable[[], Any]) -> Any:
        """``fn()``, recorded in the ledger with its wall time when the
        function is instrumented."""
        if self.closure is None:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        self.closure.record({}, time.perf_counter() - t0)
        return out

    @property
    def may_capture(self) -> bool:
        """Whether a later call may capture: on the card, not eager, and
        no graph yet."""
        return (self.device.type == "cuda" and not self.eager
                and self.graph is None)

    def __call__(self) -> None:
        with launch_guard():
            if self.device.type != "cuda" or self.eager:
                if self.calls == 0:
                    self._timed(self.fn)
                else:
                    self.fn()
            elif self.calls == 0:
                _on_side_stream(self.fn, self.device)
            else:
                if self.graph is None:
                    self.graph, self.launches, self.memory = self._timed(
                        lambda: _capture(self.fn, pool=self.pool))
                self.graph.replay()
                ops.add_launches(self.launches)
                self.replays += 1
            self.calls += 1
