"""Registry of HOT entry points: the real steps the port's examples,
``chip_smoke.py`` and the serving engines run, traced for the rule engine.

Counterpart of ``apex_tpu/analysis/entry_points.py``: every entry of the
JAX registry, under the same name and tags, over the port's own steps —
``parallel.make_step`` for the training steps, the engines'
``_graph.CapturedFn`` bodies for ``engine_step_k``,
``engine_prefill_slot``, ``paged_step_k``, ``paged_admit`` and
``seq2seq_step_k``.  Expectations are derived from the subsystems that
own them, as in the JAX package: conv/matmul dtypes from
``amp.compute_dtype``, the collective census from
``parallel.allreduce_comm_plan`` / ``zero_update_comm_plan`` /
``overlap_comm_schedule``, donation names from ``serving``'s constants.

**Ranks.**  An entry whose step runs collectives (``ranks > 1``) is
traced inside gloo ranks on the CPU, at the JAX package's mesh sizes (8
ranks in place of its virtual 8-device mesh; ``ddp_resnet18_o2_hier_
world4`` on the first 4 of them, the TP step on a 2 x 4 grid).  Every
rank builds and traces the step on its share of the batch, the ranks
check that they recorded the same graph, and rank 0's trace (with every
rank's state digests, for ``sharding``) comes back.  :func:`prefetch`
traces all such entries of a selection in one start of the ranks (the
CLI and ``core.run_lint`` call it); :func:`rank_job` is what each rank
runs.  Single-rank entries (the engines) trace in the calling process.

Builders run lazily and cache: registering is free, ``ep.graph()`` pays
the trace once per process.  A build restores the global amp cast policy
(``amp.initialize(O1)`` installs one process-wide) and leaves nothing
behind.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from . import graphs as G
from .graphs import Graph

__all__ = ["EntryPoint", "ENTRY_POINTS", "register_entry_point", "get",
           "select", "names", "entry_point_memory_record", "prefetch",
           "rank_job", "install", "RANKS"]

# the JAX package's virtual mesh: the ranks a multi-rank trace starts
RANKS = 8
# the trace's device: "cpu" (tests, the CLI, the gloo ranks); a caller
# that traces the single-rank entries on the card sets it to "cuda"
DEVICE = "cpu"


def entry_point_memory_record(ep: "EntryPoint") -> Dict[str, Any]:
    """One ``kind: memory`` record for an entry point: the analytic cost
    (``ep.cost()``) merged with the memory plan of the recorded graph
    (``ep.memory_plan()``), shaped for
    ``exporters.validate_memory_record``."""
    cost = ep.cost()
    rec = {"kind": "memory", "entry_point": ep.name, "source": "analytic",
           **cost.to_record(), **ep.memory_plan()}
    dt = cost.dominant_matmul_dtype
    if dt is not None:
        rec["dominant_matmul_dtype"] = dt
    return rec


class EntryPoint:
    """One hot step: ``build(ep)`` returns a :class:`Graph` (``None`` on a
    rank outside the step's world) and may fill derived expectations into
    ``ep.expect`` before rules run.  ``ranks``: the ranks the trace
    needs (1: the calling process)."""

    def __init__(self, name: str, build: Callable[["EntryPoint"], Graph],
                 tags: Iterable[str] = (),
                 expect: Optional[Dict[str, Any]] = None,
                 description: str = "", ranks: int = 1):
        self.name = name
        self.tags = frozenset(tags)
        self.expect: Dict[str, Any] = dict(expect or {})
        self.description = description
        self.ranks = int(ranks)
        self._build = build
        self._graph: Optional[Graph] = None
        self._built = False
        self._live = None

    def graph(self) -> Optional[Graph]:
        if not self._built:
            if self.ranks > 1 and _world() == 1:
                prefetch([self])
                return self._graph
            # leak barrier: amp.initialize(O1) installs a process-wide cast
            # policy; without the restore, building the O1 entry would
            # re-dtype every graph built after it
            from ..amp import policy as amp_policy
            base = amp_policy.current_policy()
            try:
                self._graph = self._build(self)
            finally:
                amp_policy.set_policy(base)
            self._built = True
        return self._graph

    def cost(self):
        """The analytic :class:`observability.costmodel.Cost` of the
        traced call (counted in the same call)."""
        return self.graph().cost

    def live_bytes(self) -> Dict[str, Any]:
        """``observability.memory.graph_live_bytes`` of the recorded
        graph, cached."""
        if self._live is None:
            from ..observability import memory
            self._live = memory.graph_live_bytes(self.graph().fx())
        return self._live

    def memory_plan(self) -> Dict[str, Any]:
        """The memory plan of the recorded graph, in the captured plan's
        fields (``observability.memory.memory_plan``): the arguments, the
        outputs (returned and state), the peak temporaries, the state
        updated in place as the aliased bytes."""
        g = self.graph()
        lb = self.live_bytes()
        alias = sum(f.before.nbytes for f in g.state if f.in_place)
        outs = sum(f.before.nbytes for f in g.state) \
            + g.info.get("returned_bytes", 0)
        plan = {"argument_bytes": int(lb["argument_bytes"]),
                "output_bytes": int(outs),
                "temp_bytes": int(lb["peak_temp_bytes"]),
                "alias_bytes": int(alias), "generated_code_bytes": 0}
        plan["peak_bytes"] = (plan["argument_bytes"] + plan["output_bytes"]
                              + plan["temp_bytes"] - plan["alias_bytes"])
        plan["analytic_live_bytes"] = int(lb["peak_live_bytes"])
        plan["analytic_temp_bytes"] = int(lb["peak_temp_bytes"])
        plan["analytic_temp_bytes_by_dtype"] = dict(
            lb["peak_temp_bytes_by_dtype"])
        return plan

    def __repr__(self):
        return f"EntryPoint({self.name!r}, tags={sorted(self.tags)})"


ENTRY_POINTS: Dict[str, EntryPoint] = {}


def register_entry_point(name: str, tags: Iterable[str] = (),
                         expect: Optional[Dict[str, Any]] = None,
                         description: str = "", ranks: int = 1):
    def deco(build):
        if name in ENTRY_POINTS:
            raise ValueError(f"duplicate entry point {name!r}")
        ENTRY_POINTS[name] = EntryPoint(name, build, tags=tags,
                                        expect=expect,
                                        description=description,
                                        ranks=ranks)
        return build
    return deco


def get(name: str) -> EntryPoint:
    try:
        return ENTRY_POINTS[name]
    except KeyError:
        raise KeyError(f"unknown entry point {name!r}; known: "
                       f"{sorted(ENTRY_POINTS)}")


def names() -> List[str]:
    return list(ENTRY_POINTS)


def select(names: Optional[Iterable[str]] = None,
           tags: Optional[Iterable[str]] = None) -> List[EntryPoint]:
    if names is not None:
        return [get(n) for n in names]
    eps = list(ENTRY_POINTS.values())
    if tags is not None:
        tags = frozenset(tags)
        eps = [ep for ep in eps if ep.tags & tags]
    return eps


# -- the ranks --------------------------------------------------------------

def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _require_ranks(n: int) -> None:
    if _world() < n:
        raise RuntimeError(
            f"this entry point traces on {n} ranks; the process group has "
            f"{_world()} (entry_points.prefetch starts them)")


def _first(n: int):
    """The group of the first ``n`` ranks (``None``: the default group),
    made on every rank; ranks at or above ``n`` get ``None`` too."""
    from ..parallel import topology
    if n == _world():
        return None
    return topology._split([list(range(n))])


def rank_job(names: Iterable[str]) -> Dict[str, Any]:
    """What each gloo rank runs: build and trace every named entry (each
    rank its share), ``{name: (expectations, trace)}`` on rank 0."""
    out = {}
    for name in names:
        ep = get(name)
        g = ep.graph()
        if g is not None and _rank() == 0:
            out[name] = (dict(ep.expect), g.trace)
    return out


def install(results: Dict[str, Any]) -> None:
    """Take the ranks' traces: each entry's graph, and the expectations
    its build derived where the entry has none of its own."""
    for name, (expect, trace) in results.items():
        ep = get(name)
        ep._graph = Graph(recorded=trace)
        ep._built = True
        ep._live = None
        for k, v in expect.items():
            ep.expect.setdefault(k, v)


def prefetch(entry_points: Iterable[EntryPoint], world: int = RANKS,
             timeout: float = 900.0) -> None:
    """Trace every multi-rank entry of ``entry_points`` not traced yet, in
    one start of ``world`` gloo ranks through the port's launcher
    (``python -m apex_tpu_torch.parallel.multiproc``)."""
    todo = [ep.name for ep in entry_points if ep.ranks > 1
            and not ep._built]
    if not todo or _world() > 1:
        return
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "__main__.py")
    with tempfile.TemporaryDirectory(prefix="apex_analysis_") as d:
        job, out = os.path.join(d, "job.pkl"), os.path.join(d, "out.pkl")
        with open(job, "wb") as f:
            pickle.dump({"names": todo}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [repo] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        res = subprocess.run(
            [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
             "--nprocs", str(world), "--init-method",
             f"file://{os.path.join(d, 'store')}", main, "--rank-job", job,
             out], cwd=repo, env=env, capture_output=True, text=True,
            timeout=timeout)
        if res.returncode != 0:
            raise RuntimeError(f"the analysis ranks failed (rc "
                               f"{res.returncode}):\n{res.stdout[-3000:]}"
                               f"\n{res.stderr[-6000:]}")
        with open(out, "rb") as f:
            install(pickle.load(f))


def _agree(trace, group) -> None:
    """Every rank of ``group`` recorded the same graph."""
    import hashlib
    import torch.distributed as dist
    mine = hashlib.sha1(G.text(trace).encode()).hexdigest()
    got: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, mine, group=group)
    if len(set(got)) != 1:
        raise RuntimeError(f"the ranks recorded different graphs: {got}")


def trace_ranked(step: Callable, *args, state: Callable, group,
                 mesh_axes: Dict[str, int], sharded=(), cost: bool = True,
                 **kwargs) -> Graph:
    """Trace ``step(*args, **kwargs)`` on every rank of ``group`` (``None``:
    the world) with the state digests, check the ranks agree, and return
    the graph; rank 0 of the group's carries the sharding facts
    (``sharding.rank_sharding_info``)."""
    import torch.distributed as dist
    from . import sharding as S
    world = dist.get_world_size(group)
    trace = G.trace_call(step, *args, state=state, cost=cost, digests=True,
                         info={"world": world, "mesh_axes": dict(mesh_axes)},
                         **kwargs)
    _agree(trace, group)
    info = S.rank_sharding_info(trace, mesh_axes, sharded, group)
    if info is not None:
        trace.info["sharding"] = info
    return Graph(recorded=trace)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _gen(seed: int):
    import torch
    return torch.Generator().manual_seed(seed)


def _share(a: np.ndarray, group) -> np.ndarray:
    """This rank's rows of a global batch."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    k = a.shape[0] // n
    r = dist.get_rank(group)
    return a[r * k:(r + 1) * k]


def _training_state(model, opt, **extra):
    """The state of a training step: the model's parameters and buffers,
    the amp optimizer's (masters, moments, scalers), and ``extra``."""
    def state():
        out = {"params": dict(model.named_parameters()),
               "buffers": dict(model.named_buffers()),
               "opt": opt.state_dict()}
        out.update({k: (v() if callable(v) else v)
                    for k, v in extra.items()})
        return out
    return state


# -- DDP ResNet train steps (O0-O3, layouts, telemetry) -------------------

# activation threshold for the layout rule (the JAX package's: one NHWC
# (4, 32, 32, 3) input batch) — a relayout that size or bigger is of real
# data, not index bookkeeping
_RESNET_ACT_ELEMS = 4 * 3 * 32 * 32


def _ddp_resnet_graph(ep, opt_level, channels_last=False,
                      input_format="NCHW", stem="conv7",
                      telemetry=False, B=16, image=32,
                      comm_topology="flat", compress=False,
                      ici_size=None, numerics=None, supervised=None,
                      world=None):
    """The REAL DDP train step through ``parallel.make_step``: resnet18 at
    ``opt_level`` with FusedAdam, the functional step
    (``amp.scaled_grad``, ``ddp.allreduce_grads``, ``optimizer.step``),
    the loss averaged over the group, on this rank's share of the batch.
    ``telemetry`` updates a ``DeviceMetrics`` in place; ``numerics="on"``
    a ``NumericsMonitor`` (grad health, the buckets, the digest over the
    group), ``"off"`` the same step code with a disabled monitor (which
    must record the baseline's graph); ``supervised`` routes the step
    through ``RunSupervisor.wrap_step``; ``world=N`` traces on the group
    of the first N ranks (the post-shrink step of an elastic run), the
    hierarchy's node groups inside it."""
    import torch
    import torch.distributed as dist
    from .. import amp, models, observability, optimizers, parallel
    from ..nn.functional import cross_entropy
    from ..observability import numerics as obs_numerics
    from ..parallel import topology

    ndev = world if world is not None else RANKS
    _require_ranks(ndev)
    if ici_size is not None and ndev % ici_size:
        raise RuntimeError(f"this entry point needs a multiple of "
                           f"ici_size={ici_size} ranks; it has {ndev}")
    group = _first(ndev)
    if comm_topology == "hierarchical":
        topology.hierarchical_groups(ici_size, ndev, range(ndev))
    if _rank() >= ndev:
        return None
    dev = DEVICE
    model = models.resnet18(num_classes=10, channels_last=channels_last,
                            input_format=input_format, stem=stem,
                            device=dev, generator=_gen(0))
    model, opt = amp.initialize(model, optimizers.FusedAdam(1e-3),
                                opt_level=opt_level, verbosity=0)
    ddp = parallel.DistributedDataParallel(
        model, comm_topology=comm_topology,
        allreduce_compress_bf16=compress, ici_size=ici_size,
        process_group=group)
    rng = np.random.RandomState(0)
    shape = (B, 3, image, image) if input_format == "NCHW" \
        else (B, image, image, 3)
    x = torch.from_numpy(_share(rng.randn(*shape).astype(np.float32),
                                group)).to(dev)
    y = torch.from_numpy(_share(rng.randint(0, 10, B), group)).to(dev)
    dm = observability.DeviceMetrics(
        counters=("steps", "overflows"),
        gauges=("loss_scale", "grad_norm"), device=dev) if telemetry \
        else None
    tele = dm.init() if dm is not None else None
    plan = parallel.allreduce_comm_plan(
        dict(model.named_parameters()), comm_topology=comm_topology,
        allreduce_compress_bf16=compress, ici_size=ici_size, world=ndev,
        nproc=1)
    nm = ntele = None
    digest_plan: list = []
    if numerics is not None:
        digest_plan = obs_numerics.digest_comm_plan(
            dict(model.named_parameters()))
        nm = obs_numerics.NumericsMonitor(
            model, half_dtype="bfloat16",
            bucket_labels=obs_numerics.bucket_labels(plan), digest=True,
            axis_name=group if group is not None else "data",
            enabled=(numerics == "on"), device=dev)
        ntele = nm.init()

    def step(batch):
        xb, yb = batch
        loss, grads = amp.scaled_grad(
            lambda: cross_entropy(model(xb), yb), opt)
        if nm is not None and nm.enabled:
            nout: list = []
            grads = ddp.allreduce_grads(grads, numerics_out=nout)
            info = opt.step(grads, grad_health=nm)
            nm.update(ntele, grad_stats=info["grad_health"],
                      bucket_stats=nout, found_inf=info["found_inf"],
                      loss_scale=info["loss_scale"], sync_tree=model)
        else:
            grads = ddp.allreduce_grads(grads)
            info = opt.step(grads)
            if telemetry:
                dm.inc(tele, "steps")
                dm.inc(tele, "overflows", info["found_inf"])
                dm.set(tele, "loss_scale", info["loss_scale"])
                dm.set(tele, "grad_norm", info["grad_norm"])
            if nm is not None:
                nm.update(ntele)       # disabled: an identity
        mean = loss.detach().clone()
        dist.all_reduce(mean, group=group)
        return mean / ndev

    if supervised is not None:
        sup = observability.RunSupervisor(
            f"ep_{ep.name}", enabled=(supervised == "on"),
            registry=observability.MetricsRegistry())
        step = sup.wrap_step(step)
        ep.expect.setdefault("supervisor", {
            "baseline": "ddp_resnet18_o2", "enabled": supervised == "on"})
    # the divergent-output ledger: every rank updates its BatchNorm
    # running statistics from its LOCAL batch (the non-SyncBN semantics),
    # so each floating BN buffer (2 x 20 layers) differs across ranks
    divergent = sum(1 for b in model.buffers() if b.is_floating_point())
    if numerics == "on":
        # the monitor's per-bucket magnitudes (abs max, square sum) are
        # of this rank's pre-reduction buffer until their flush; its
        # nonfinite counts agree while every rank is finite (the JAX
        # propagator declares all three)
        divergent += 2
    _fill_ddp_expectations(ep, opt_level, plan,
                           extra_plan=digest_plan if numerics == "on"
                           else None, world=ndev,
                           divergent_outputs=divergent)
    if numerics is not None:
        ep.expect.setdefault("numerics", {
            "baseline": "ddp_resnet18_o2", "enabled": numerics == "on",
            "extra_collectives": {"psum": 1} if numerics == "on" else {},
            "extra_payload_bytes": (digest_plan[0]["wire_bytes"]
                                    if numerics == "on" else 0)})
    train = parallel.make_step(step, model)
    extra = {}
    if tele is not None:
        extra["tele"] = tele
    if ntele:
        extra["numerics"] = ntele
    return trace_ranked(train, (x, y), group=group,
                        mesh_axes={"data": ndev},
                        state=_training_state(model, opt, **extra))


def _unit_census(exp: Dict[str, Any], plan) -> Dict[str, Any]:
    """The collective expectation of the port's runtime: a flat bucket
    cut into ``chunks`` (a bucket past ``message_size``) is one psum
    equation in the JAX package (over the chunk-stacked buffer) and one
    all-reduce a chunk in the port (each unit goes out as it fills, which
    the hook path overlaps); the payloads are the same."""
    extra = sum(b["chunks"] - 1 for b in plan
                if b.get("topology") == "flat" and b.get("chunks", 1) > 1)
    if extra:
        exp["counts"]["psum"] = exp["counts"].get("psum", 0) + extra
    return exp


def _fill_ddp_expectations(ep, opt_level, plan, extra_plan=None,
                           world=RANKS, divergent_outputs=0):
    """The amp, collective, cost, memory, donation and sharding
    expectations of a DDP train step (the JAX package's
    ``_fill_ddp_expectations``).  The collective population is the plan's
    buckets plus the step's one fp32 scalar all-reduce (the loss
    average); the JAX step adds a second, the axis-size psum its
    ``gradient_average`` divides by, which the port does not need (the
    world is known on the host)."""
    from .. import amp, parallel
    dt = _dtype_name(amp.compute_dtype(opt_level))
    ep.expect.setdefault("amp", {
        # resnet18: 20 forward convs and 20 convolution_backward nodes
        "opt_level": opt_level, "conv_dtype": dt, "min_convs": 40,
        "dot_dtype": dt, "min_dots": 1})
    ep.expect.setdefault(
        "collectives",
        _unit_census(parallel.plan_collective_expectations(
            plan + list(extra_plan or []), extra_psums=1,
            extra_psum_bytes=4), plan))
    if dt != "float32":
        ep.expect.setdefault("flops", {"max_fp32_matmul_fraction": 0.02,
                                       "min_matmul_flops": 1e6})
    ep.expect.setdefault("memory", {"max_live_to_argument_ratio": 4.0})
    ep.expect.setdefault("donation", {
        "expect_donated": ("params", "buffers", "opt")})
    ep.expect.setdefault("sharding", {
        "mesh_axes": {"data": world},
        "divergent_outputs": divergent_outputs})
    ep.expect.setdefault(
        "resharding",
        parallel.plan_resharding_expectations(
            plan + list(extra_plan or [])))


for _lvl in ("O0", "O1", "O2", "O3"):
    register_entry_point(
        f"ddp_resnet18_{_lvl.lower()}", tags=("training", "ddp", "amp"),
        ranks=RANKS,
        description=f"DDP resnet18 {_lvl} train step, NCHW, 8 ranks")(
        lambda ep, lvl=_lvl: _ddp_resnet_graph(ep, lvl))

register_entry_point(
    "ddp_resnet18_o2_telemetry", tags=("training", "ddp", "amp",
                                       "telemetry"), ranks=RANKS,
    description="DDP resnet18 O2 step with DeviceMetrics updated in place "
                "— must stay host-sync-free")(
    lambda ep: _ddp_resnet_graph(ep, "O2", telemetry=True))

register_entry_point(
    "ddp_resnet18_o2_numerics", tags=("training", "ddp", "amp",
                                      "numerics", "telemetry"), ranks=RANKS,
    description="DDP resnet18 O2 step with device-resident numerics "
                "accounting (grad health + bucket stats + divergence "
                "digest) — no host sync, plan-exact collectives")(
    lambda ep: _ddp_resnet_graph(ep, "O2", numerics="on"))

register_entry_point(
    "ddp_resnet18_o2_numerics_off", tags=("training", "ddp", "numerics"),
    ranks=RANKS,
    description="DDP resnet18 O2 step with numerics DISABLED — must "
                "record the uninstrumented step's graph")(
    lambda ep: _ddp_resnet_graph(ep, "O2", numerics="off"))

register_entry_point(
    "ddp_resnet18_o2_supervised", tags=("training", "ddp", "amp",
                                        "supervisor", "telemetry"),
    ranks=RANKS,
    description="DDP resnet18 O2 step under an ENABLED run supervisor — "
                "the bare step's graph (the supervisor reads host flush "
                "points only)")(
    lambda ep: _ddp_resnet_graph(ep, "O2", supervised="on"))

register_entry_point(
    "ddp_resnet18_o2_supervised_off", tags=("training", "ddp",
                                            "supervisor"), ranks=RANKS,
    description="DDP resnet18 O2 step under a DISABLED run supervisor — "
                "the bare step's graph")(
    lambda ep: _ddp_resnet_graph(ep, "O2", supervised="off"))

register_entry_point(
    "ddp_resnet18_o2_nhwc", tags=("training", "ddp", "amp", "layout"),
    ranks=RANKS,
    expect={"layout": {"min_activation_elems": _RESNET_ACT_ELEMS,
                       "allowed_6d_rearranges": 0}},
    description="DDP resnet18 O2 channels-last step — relayout-free")(
    lambda ep: _ddp_resnet_graph(ep, "O2", channels_last=True,
                                 input_format="NHWC"))

register_entry_point(
    "ddp_resnet18_o2_hier", tags=("training", "ddp", "amp", "hier"),
    ranks=RANKS,
    description="DDP resnet18 O2 step, hierarchical two-level allreduce "
                "(ici_size=4 on 8 ranks)")(
    lambda ep: _ddp_resnet_graph(ep, "O2", comm_topology="hierarchical",
                                 ici_size=4))

register_entry_point(
    "ddp_resnet18_o2_hier_bf16", tags=("training", "ddp", "amp", "hier"),
    ranks=RANKS,
    description="DDP resnet18 O2 step, hierarchical allreduce with the "
                "bf16-compressed cross-node hop")(
    lambda ep: _ddp_resnet_graph(ep, "O2", comm_topology="hierarchical",
                                 ici_size=4, compress=True))

# elastic recovery: the POST-SHRINK step (8 -> 4, ici_size 4 -> 2) on the
# group of the first 4 ranks, the node groups inside it, expectations
# re-derived from allreduce_comm_plan at the new world
register_entry_point(
    "ddp_resnet18_o2_hier_world4", tags=("training", "ddp", "amp",
                                         "hier", "recovery"), ranks=RANKS,
    description="DDP resnet18 O2 step on the shrunk 4-rank world "
                "(ici_size=2) — the post-recovery step, plan-derived "
                "expectations at world 4")(
    lambda ep: _ddp_resnet_graph(ep, "O2", comm_topology="hierarchical",
                                 ici_size=2, world=4))

register_entry_point(
    "ddp_resnet18_o2_nhwc_s2d", tags=("training", "ddp", "amp", "layout"),
    ranks=RANKS,
    # the 6-D block rearrange of space_to_depth is the ONE sanctioned
    # activation relayout (forward only: the input needs no gradient)
    expect={"layout": {"min_activation_elems": _RESNET_ACT_ELEMS,
                       "allowed_6d_rearranges": 1}},
    description="DDP resnet18 O2 NHWC space-to-depth stem step")(
    lambda ep: _ddp_resnet_graph(ep, "O2", channels_last=True,
                                 input_format="NHWC",
                                 stem="space_to_depth"))


# -- overlapped gradient communication -------------------------------------

def _stage_params(stages, hidden, seed):
    import torch
    rng = np.random.RandomState(seed)
    return [{"w": torch.from_numpy((rng.randn(hidden, hidden) * 0.1)
                                   .astype(np.float32)).to(DEVICE)
             .requires_grad_(),
             "b": torch.zeros(hidden, device=DEVICE).requires_grad_()}
            for _ in range(stages)], rng


def _staged_mlp_graph(ep, overlap=True, comm_topology="hierarchical",
                      compress=False, ici_size=4, stages=4, hidden=32,
                      B=8, zero2=False):
    """The overlapped DDP train step: a ``stages``-deep MLP whose backward
    runs stage by stage through ``staged_allreduce_grads`` (with
    ``zero2``, ``staged_zero2_allreduce_grads``: each stage's in-node
    reduce-scatter, cross-node reduce, shard update and in-node
    gather-back), the params updated in place.  With ``overlap=True``
    each stage's buckets go out while the earlier stages' backward runs:
    a position property of the recorded graph, which only the
    interleaving check sees."""
    import torch
    import torch.distributed as dist
    from .. import parallel
    from ..parallel import topology

    _require_ranks(RANKS)
    if ici_size is not None:
        topology.hierarchical_groups(ici_size, RANKS)
    stage_params, rng = _stage_params(stages, hidden,
                                      20 if zero2 else 14)
    x = torch.from_numpy(_share(rng.randn(B, hidden).astype(np.float32),
                                None)).to(DEVICE)
    y = torch.from_numpy(_share(rng.randn(B, hidden).astype(np.float32),
                                None)).to(DEVICE)
    holder = torch.nn.Linear(1, 1, bias=False, device=DEVICE)
    ddp = parallel.DistributedDataParallel(
        holder, comm_topology=comm_topology,
        allreduce_compress_bf16=compress, ici_size=ici_size,
        overlap=overlap, zero_stage=2 if zero2 else None)

    def stage_fn(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    def head(a):
        return ((a - y) ** 2).mean()

    def step(batch):
        xb = batch
        if zero2:
            loss, new = ddp.staged_zero2_allreduce_grads(
                [stage_fn] * stages, head, stage_params, xb,
                lambda stage, p_sh, g_sh: p_sh - 0.1 * g_sh)
        else:
            loss, grads = ddp.staged_allreduce_grads(
                [stage_fn] * stages, head, stage_params, xb)
            new = [{k: p[k] - 0.1 * g[k] for k in p}
                   for p, g in zip(stage_params, grads)]
        with torch.no_grad():
            for p, n in zip(stage_params, new):
                for k in p:
                    p[k].copy_(n[k])
        mean = loss.detach().clone()
        dist.all_reduce(mean)
        return mean / RANKS

    schedule = parallel.overlap_comm_schedule(
        stage_params, comm_topology=comm_topology,
        allreduce_compress_bf16=compress, ici_size=ici_size, world=RANKS,
        nproc=1, overlap=overlap, zero_stage=2 if zero2 else None)
    # the schedule's census plus the loss average (the JAX step adds the
    # shared axis-size psum, which the port does not need)
    ep.expect.setdefault(
        "collectives",
        parallel.overlap_collective_expectations(
            schedule, extra_psums=1, extra_psum_bytes=4))
    ep.expect.setdefault("memory", {"max_live_to_argument_ratio": 4.0})
    ep.expect.setdefault("donation", {"expect_donated": ("params",)})
    # every stage's params come back equal on every rank (the run-time
    # check sees the agreement the JAX propagator cannot prove for the
    # in-node gather-back of ZeRO-2)
    sharding = {"mesh_axes": {"data": RANKS}, "divergent_outputs": 0}
    if zero2:
        # measured: the replicated stage params, 118,272 bytes (the JAX
        # package's figure), declared at ~1.05x
        sharding["max_replicated_bytes"] = 124_000
    ep.expect.setdefault("sharding", sharding)
    ep.expect.setdefault(
        "resharding",
        parallel.plan_resharding_expectations(schedule["buckets"]))
    return trace_ranked(step, x, group=None, mesh_axes={"data": RANKS},
                        state=lambda: {"params": stage_params})


register_entry_point(
    "ddp_mlp_overlap_flat", tags=("training", "ddp", "overlap"),
    ranks=RANKS,
    description="staged 4-stage MLP DDP step, OVERLAPPED flat allreduce — "
                "per-stage all-reduces interleaved with the backward, "
                "position-pinned")(
    lambda ep: _staged_mlp_graph(ep, comm_topology="flat", ici_size=None))

register_entry_point(
    "ddp_mlp_overlap_hier", tags=("training", "ddp", "overlap", "hier"),
    ranks=RANKS,
    description="staged 4-stage MLP DDP step, OVERLAPPED hierarchical "
                "allreduce (ici_size=4) — each bucket's reduce-scatter / "
                "cross-node all-reduce / all-gather issued while the "
                "earlier stages are still in backward")(
    lambda ep: _staged_mlp_graph(ep))

register_entry_point(
    "ddp_mlp_overlap_hier_bf16", tags=("training", "ddp", "overlap",
                                       "hier"), ranks=RANKS,
    description="staged 4-stage MLP DDP step, overlapped hierarchical "
                "allreduce with the bf16-compressed cross-node hop")(
    lambda ep: _staged_mlp_graph(ep, compress=True))


# -- ZeRO weight-update sharding --------------------------------------------

def _zero_collective_expectations(plan):
    """A ``zero_update_comm_plan`` plus the step's three scalar
    collectives outside it — the grad-norm all-reduce, the loss average
    and the MAX all-reduce of the overflow flag (ZeRO shards must skip
    together) — the JAX package's three."""
    from .. import parallel
    exp = parallel.plan_collective_expectations(
        plan, extra_psums=2, extra_psum_bytes=2 * 4)
    exp["counts"]["pmax"] = exp["counts"].get("pmax", 0) + 1
    exp["payload_bytes"] += 4
    by = exp["payload_bytes_by_primitive"]
    by["pmax"] = by.get("pmax", 0) + 4
    return exp


# measured on the port's recorded graphs (CPU, 8 ranks, 2 samples a rank:
# graph_live_bytes and the ranks' ledger), declared at ~1.05x so a
# regression (state off its address, a second fp32 activation tree)
# trips while trace noise does not:
#   zero1  live/args 1.152  temps {bf16 22.7M, f32 11.2M}  repl 156.9M
#   zero2  live/args 1.137  temps {bf16 22.7M, f32 22.4M}  repl 156.9M
#   zero3  live/args 1.750  temps {bf16 45.1M, f32 55.9M}  repl 0.27M
# (the replicated bytes are the bf16 model of stages 1/2, the JAX
# package's 156.9 MB; stage 3's are the BatchNorm state and the scaler)
_SMALL_TEMPS = {"int64": 69_000, "bool": 540, "int32": 16}
_ZERO_MEMORY = {
    1: {"max_live_to_argument_ratio": 1.21,
        "temp_budget_bytes_by_dtype": {
            "bfloat16": 23_900_000, "float32": 11_750_000, **_SMALL_TEMPS}},
    2: {"max_live_to_argument_ratio": 1.20,
        "temp_budget_bytes_by_dtype": {
            "bfloat16": 23_900_000, "float32": 23_500_000, **_SMALL_TEMPS}},
    3: {"max_live_to_argument_ratio": 1.84,
        "temp_budget_bytes_by_dtype": {
            "bfloat16": 47_400_000, "float32": 58_700_000, **_SMALL_TEMPS}},
}
_ZERO_REPLICATED = {1: 164_800_000, 2: 164_800_000, 3: 283_000}


def _zero_resnet_graph(ep, zero_stage, compress=False, ici_size=4, B=16,
                       image=32):
    """The ZeRO train step on 8 ranks: the O2 resnet18 forward/backward of
    ``ddp_resnet18_o2`` with no DDP reduction — ``AmpOptimizer.step``
    owns it (stage 1: full-world reduce-scatter, shard update, all-gather
    of the updated params; stage 2: in-node reduce-scatter and cross-node
    reduce of the 1/ici shard, in-node gather-back; stage 3: the fp32
    master window is the parameter store, the forward gathers it just in
    time and its checkpoint policy re-gathers in the backward)."""
    import torch
    import torch.distributed as dist
    from .. import amp, models, optimizers, parallel
    from ..nn.functional import cross_entropy
    from ..parallel import topology

    world = RANKS
    _require_ranks(world)
    isz = ici_size if zero_stage >= 2 else None
    if isz is not None:
        topology.hierarchical_groups(isz, world)
    model = models.resnet18(num_classes=10, device=DEVICE,
                            generator=_gen(0))
    model, opt = amp.initialize(model, optimizers.FusedAdam(1e-3),
                                opt_level="O2", verbosity=0)
    shapes = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
              for n, p in model.named_parameters()}
    opt.zero_shard(zero_stage=zero_stage, zero_ici_size=isz,
                   zero_compress_bf16=compress)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(_share(rng.randn(B, 3, image, image)
                                .astype(np.float32), None)).to(DEVICE)
    y = torch.from_numpy(_share(rng.randint(0, 10, B), None)).to(DEVICE)

    def step(batch):
        xb, yb = batch
        if zero_stage == 3:
            with amp.zero_gather_checkpoint_policy(opt):
                loss, g = amp.scaled_grad(lambda: cross_entropy(
                    torch.func.functional_call(
                        model, amp.zero_gather_params(opt), (xb,)), yb),
                    opt)
        else:
            loss, g = amp.scaled_grad(
                lambda: cross_entropy(model(xb), yb), opt)
        opt.step(g)
        mean = loss.detach().clone()
        dist.all_reduce(mean)
        return mean / world

    plan = parallel.zero_update_comm_plan(
        shapes, zero_stage=zero_stage, world=world, ici_size=isz,
        zero_compress_bf16=compress)
    dt = _dtype_name(amp.compute_dtype("O2"))
    ep.expect.setdefault("amp", {
        "opt_level": "O2", "conv_dtype": dt, "min_convs": 40,
        "dot_dtype": dt, "min_dots": 1})
    ep.expect.setdefault("collectives",
                         _zero_collective_expectations(plan))
    ep.expect.setdefault("flops", {"max_fp32_matmul_fraction": 0.02,
                                   "min_matmul_flops": 1e6})
    ep.expect.setdefault("memory", dict(_ZERO_MEMORY[zero_stage]))
    ep.expect.setdefault("donation", {
        "expect_donated": ("buffers", "opt") if zero_stage == 3
        else ("params", "buffers", "opt")})
    divergent = sum(1 for b in model.buffers() if b.is_floating_point())
    sharding = {"mesh_axes": {"data": world},
                "divergent_outputs": divergent}
    if _ZERO_REPLICATED[zero_stage] is not None:
        sharding["max_replicated_bytes"] = _ZERO_REPLICATED[zero_stage]
    ep.expect.setdefault("sharding", sharding)
    ep.expect.setdefault("resharding",
                         parallel.plan_resharding_expectations(plan))
    train = parallel.make_step(step, model)
    # the windows: each rank holds its own (sharded by design)
    return trace_ranked(train, (x, y), group=None,
                        mesh_axes={"data": world},
                        sharded=("opt.masters", "opt.inner"),
                        state=_training_state(model, opt))


register_entry_point(
    "ddp_resnet18_o2_zero1", tags=("training", "ddp", "amp", "zero"),
    ranks=RANKS,
    description="O2 resnet18 ZeRO-1 step — optimizer state sharded "
                "1/world, full-world reduce-scatter + all-gather owned by "
                "the optimizer")(
    lambda ep: _zero_resnet_graph(ep, 1))

register_entry_point(
    "ddp_resnet18_o2_zero2", tags=("training", "ddp", "amp", "zero",
                                   "hier"), ranks=RANKS,
    description="O2 resnet18 ZeRO-2 step on the hierarchical fabric "
                "(ici_size=4): in-node grad reduce-scatter + cross-node "
                "shard reduce, in-node gather-back")(
    lambda ep: _zero_resnet_graph(ep, 2))

register_entry_point(
    "ddp_resnet18_o2_zero3", tags=("training", "ddp", "amp", "zero",
                                   "hier"), ranks=RANKS,
    description="O2 resnet18 ZeRO-3 step: the fp32 master window is the "
                "parameter store, just-in-time in-node gather in forward "
                "+ checkpoint re-gather in backward")(
    lambda ep: _zero_resnet_graph(ep, 3))

register_entry_point(
    "ddp_mlp_overlap_zero2", tags=("training", "ddp", "overlap", "hier",
                                   "zero"), ranks=RANKS,
    description="staged 4-stage MLP, OVERLAPPED hierarchical ZeRO-2 fused "
                "update: per-stage in-node reduce-scatter + cross-node "
                "shard reduce + shard update + in-node gather-back, "
                "issued while earlier stages are still in backward")(
    lambda ep: _staged_mlp_graph(ep, zero2=True))


# -- transformer-family O2 train steps ---------------------------------------

def _transformer_graph(ep, family):
    """The real O2 DDP train step (fused-head loss) for a tiny transformer
    config on 8 ranks, a sequence a rank."""
    import torch
    import torch.distributed as dist
    from .. import amp, models, optimizers, parallel

    _require_ranks(RANKS)
    if family == "gpt":
        net = models.GPT(models.GPTConfig(
            vocab_size=97, block_size=16, n_layer=2, n_head=4, n_embd=32,
            dropout=0.0), device=DEVICE, generator=_gen(0))
    else:
        net = models.Llama(models.LlamaConfig(
            vocab_size=97, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=16,
            tie_word_embeddings=True), device=DEVICE, generator=_gen(0))
    model, opt = amp.initialize(net, optimizers.FusedAdam(1e-3),
                                opt_level="O2", verbosity=0)
    ddp = parallel.DistributedDataParallel(model)
    ids = torch.from_numpy(_share(np.random.RandomState(0).randint(
        0, 97, (8, 16)), None)).to(DEVICE)

    def step(batch):
        loss, g = amp.scaled_grad(lambda: model.loss(batch), opt)
        g = ddp.allreduce_grads(g)
        opt.step(g)
        mean = loss.detach().clone()
        dist.all_reduce(mean)
        return mean / RANKS

    dt = _dtype_name(amp.compute_dtype("O2"))
    ep.expect.setdefault("amp", {
        "opt_level": "O2", "dot_dtype": dt, "min_dots": 10})
    plan = parallel.allreduce_comm_plan(dict(model.named_parameters()))
    ep.expect.setdefault(
        "collectives",
        _unit_census(parallel.plan_collective_expectations(
            plan, extra_psums=1, extra_psum_bytes=4), plan))
    ep.expect.setdefault("flops", {"max_fp32_matmul_fraction": 0.02,
                                   "min_matmul_flops": 1e6})
    ep.expect.setdefault("memory", {"max_live_to_argument_ratio": 4.0})
    ep.expect.setdefault("donation", {
        "expect_donated": ("params", "opt")})
    ep.expect.setdefault("sharding", {"mesh_axes": {"data": RANKS},
                                      "divergent_outputs": 0})
    ep.expect.setdefault("resharding",
                         parallel.plan_resharding_expectations(plan))
    train = parallel.make_step(step, model)
    return trace_ranked(train, ids, group=None, mesh_axes={"data": RANKS},
                        state=_training_state(model, opt))


register_entry_point(
    "gpt_o2_train_step", tags=("training", "ddp", "amp", "transformer"),
    ranks=RANKS, description="GPT O2 DDP train step (fused-head loss)")(
    lambda ep: _transformer_graph(ep, "gpt"))

register_entry_point(
    "llama_o2_train_step", tags=("training", "ddp", "amp", "transformer"),
    ranks=RANKS,
    description="Llama O2 DDP train step (GQA, tied embeddings)")(
    lambda ep: _transformer_graph(ep, "llama"))


# -- serving engines ---------------------------------------------------------

def _tiny_gpt():
    from .. import models
    return models.GPT(models.GPTConfig(vocab_size=64, block_size=32,
                                       n_layer=2, n_head=4, n_embd=32,
                                       dropout=0.0, n_kv_head=2),
                      device=DEVICE, generator=_gen(0))


def _live_slot(eng, plen=3, limit=20):
    """Slot 0 serving a request (so the window's ticks decode), set
    directly on the engine's state."""
    import torch
    with torch.no_grad():
        eng.ids[0, :plen] = torch.arange(1, plen + 1)
        eng.cur_len[0] = plen
        eng.limit[0] = limit


def _serving_graph(eng, fn, state):
    return Graph(recorded=G.trace_call(fn, state=state))


def _engine_step_k_graph(ep):
    from .. import serving
    eng = serving.Engine(_tiny_gpt(), slots=2, buf_len=32, window=8)
    _live_slot(eng)
    n_cache = len(G.flat_tensors(eng.cache))
    ep.expect.setdefault("donation", {
        # the window's mutated state — ids, the KV cache, the sampling
        # streams (the port's "keys") — held in place; limit and eos are
        # read-only scheduler state, and so are the temperatures
        "expect_donated": ("ids", "cache", "keys"),
        "forbid_donated": ("temps", "limit", "eos"),
        "min_aliased": n_cache + 1})
    ep.expect.setdefault("memory", {"max_live_to_argument_ratio": 2.5})
    return _serving_graph(eng, eng._decode.fn, lambda: {
        "ids": eng.ids, "cur_len": eng.cur_len, "cache": eng.cache,
        "keys": {"stream": eng._stream, "step": eng._sstep},
        "temps": eng._temps, "limit": eng.limit, "eos": eng._eos})


register_entry_point(
    "engine_step_k", tags=("serving", "donation"),
    description="Engine's K-tick decode window (a CapturedFn body)")(
    _engine_step_k_graph)


def _engine_prefill_graph(ep):
    import torch
    from .. import serving
    eng = serving.Engine(_tiny_gpt(), slots=2, buf_len=32, window=8)
    with torch.no_grad():
        eng._adm[0] = 0                 # slot
        eng._adm[1] = 3                 # prompt length
        eng._adm[6:9] = torch.arange(1, 4)
    n_cache = len(G.flat_tensors(eng.cache))
    ep.expect.setdefault("donation", {
        # admission: the slot's cache row written in place; the slot and
        # the prompt row are read
        "expect_donated": ("ids", "cache"),
        "forbid_donated": ("slot", "row"),
        "min_aliased": n_cache})
    ep.expect.setdefault("memory", {"max_live_to_argument_ratio": 2.5})
    return _serving_graph(eng, eng._prefill.fn, lambda: {
        "ids": eng.ids, "cache": eng.cache, "slot": eng._adm_slot,
        "row": eng._adm_row})


register_entry_point(
    "engine_prefill_slot", tags=("serving", "donation"),
    description="Engine's per-slot admission prefill (a CapturedFn "
                "body)")(_engine_prefill_graph)


def _tiny_paged_engine():
    from .. import serving
    return serving.PagedEngine(_tiny_gpt(), slots=2, buf_len=32,
                               block_size=8, prefill_chunk=8, window=8)


def _paged_state(eng):
    return lambda: {
        "ids": eng.ids, "cur_len": eng.cur_len, "kv_len": eng.kv_len,
        "pool": eng.pool, "keys": {"stream": eng._stream,
                                   "step": eng._sstep},
        "temps": eng._temps, "limit": eng.limit, "eos": eng._eos,
        "tables": eng.tables, "n_blk": eng.n_blk,
        "free_stack": eng.free_stack, "free_top": eng.free_top,
        "pending": {"pack": eng._pend, "temps": eng._pend_t}}


def _paged_step_k_graph(ep):
    eng = _tiny_paged_engine()
    eng._stage_pending()
    n_pool = len(G.flat_tensors(eng.pool))
    ep.expect.setdefault("donation", {
        # the block pool is THE resident, held in place through the whole
        # window; the scheduler vectors are updated in place in the port
        # (the JAX step returns them as fresh outputs); the pending pack
        # is the one argument the window only reads
        "expect_donated": ("ids", "pool", "keys", "tables", "free_stack",
                           "free_top"),
        "forbid_donated": ("pending",),
        "min_aliased": n_pool + 1})
    ep.expect.setdefault("memory", {"max_live_to_argument_ratio": 4.0})
    return _serving_graph(eng, eng._windows[True].fn, _paged_state(eng))


register_entry_point(
    "paged_step_k", tags=("serving", "donation", "paged"),
    description="PagedEngine's K continuous-batching ticks (chunked "
                "prefill + decode + in-graph block recycling + "
                "iteration-boundary admission; a CapturedFn body)")(
    _paged_step_k_graph)


def _paged_admit_graph(ep):
    import torch
    eng = _tiny_paged_engine()
    with torch.no_grad():
        eng._adm[0] = 0                 # slot
        eng._adm[1] = 3                 # prompt length
        eng._adm[2] = 8                 # limit
        eng._adm[3] = -1                # eos
        eng._adm[5] = 1                 # blocks to reserve
        eng._adm[6:9] = torch.arange(1, 4)
    state = _paged_state(eng)
    ep.expect.setdefault("donation", {
        # a scheduler-row seed, not a prefill: the ids row, the slot's
        # stream and vectors and the popped blocks written in place; no
        # KV is touched, and the admission row is only read
        "expect_donated": ("ids", "keys", "tables", "free_top"),
        "forbid_donated": ("pool", "free_stack", "row"),
        "min_aliased": 2})
    ep.expect.setdefault("memory", {"max_live_to_argument_ratio": 2.5})
    return _serving_graph(eng, eng._paged_admit.fn, lambda: {
        **state(), "row": eng._adm})


register_entry_point(
    "paged_admit", tags=("serving", "donation", "paged"),
    description="PagedEngine's window-boundary block reservation + "
                "scheduler-row seed (no prefill; a CapturedFn body)")(
    _paged_admit_graph)


def _seq2seq_step_k_graph(ep):
    import torch
    from .. import models, serving
    t5 = models.T5(models.T5Config(
        vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1,
        num_heads=4, dropout_rate=0.0, relative_attention_num_buckets=8,
        relative_attention_max_distance=16), device=DEVICE,
        generator=_gen(0))
    eng = serving.Seq2SeqEngine(t5, slots=2, src_len=8, max_new_cap=8,
                                window=4)
    with torch.no_grad():
        eng.s_limit[0] = 6
    n_dec = len(G.flat_tensors(eng.state["dec"]))
    ep.expect.setdefault("donation", {
        # the slot state and the output buffer held in place; the window
        # writes the decoder cache and the output (the cross K/V and the
        # source mask are the admission's); n_new is the per-slot length
        # vector (the blocklist)
        "expect_donated": ("state", "out"),
        "forbid_donated": ("limit", "eos"),
        "min_aliased": n_dec + 1})
    ep.expect.setdefault("memory", {"max_live_to_argument_ratio": 2.5})
    return _serving_graph(eng, eng._step_k.fn, lambda: {
        "state": eng.state, "out": eng.out, "n_new": eng.n_new,
        "limit": eng.s_limit, "eos": eng._eos})


register_entry_point(
    "seq2seq_step_k", tags=("serving", "donation", "seq2seq"),
    description="Seq2SeqEngine's K decoder ticks (a CapturedFn body)")(
    _seq2seq_step_k_graph)


# -- tensor parallel ---------------------------------------------------------

def _tp_train_step_graph(ep):
    """2 x 4 (data, model) grid ParallelMLP train step: the Megatron
    pattern — ONE row-parallel all-reduce forward (the column copy's
    backward all-reduce computes dL/dx, which the data does not need, so
    autograd never runs it: the JAX package's DCE) — plus the DDP grad
    buckets over the data groups."""
    import torch
    from .. import parallel
    from ..nn import functional as F
    from ..parallel import tensor_parallel as tp
    from ..parallel import topology

    _require_ranks(RANKS)
    mesh = topology.RankMesh({"data": 2, "model": 4})
    data_g, model_g = mesh.group("data"), mesh.group("model")
    mlp = tp.ParallelMLP(8, 32, activation="relu", axis_name=model_g,
                         device=DEVICE, generator=_gen(6))
    ddp = parallel.DistributedDataParallel(mlp, process_group=data_g)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(_share(rng.randn(8, 8).astype(np.float32),
                                data_g)).to(DEVICE)
    y = torch.from_numpy(_share(rng.randn(8, 8).astype(np.float32),
                                data_g)).to(DEVICE)
    params = list(mlp.parameters())

    def step(xb, yb):
        loss = F.mse_loss(mlp(xb), yb)
        grads = torch.autograd.grad(loss, params)
        grads = ddp.allreduce_grads(list(grads))
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(0.1 * g)

    # comm accounting, derived: one model-axis all-reduce of the
    # row-parallel forward's (B/2, 8) fp32 rows, plus one bucket per plan
    # entry over the LOCAL shards (the JAX step adds the axis-size psum)
    plan = parallel.allreduce_comm_plan(dict(mlp.named_parameters()))
    act_bytes = x.shape[0] * 8 * 4
    ep.expect.setdefault(
        "collectives",
        parallel.plan_collective_expectations(
            plan, extra_psums=1, extra_psum_bytes=act_bytes))
    ep.expect.setdefault("memory", {"max_live_to_argument_ratio": 4.0})
    ep.expect.setdefault("donation", {"expect_donated": ("params",)})
    # the run-time check sees every replicated leaf agree: the JAX
    # propagator's one declared divergence (the flat grad bundle it
    # cannot see through) is not a divergence
    ep.expect.setdefault("sharding", {
        "mesh_axes": {"data": 2, "model": 4}, "divergent_outputs": 0})
    ep.expect.setdefault("resharding",
                         parallel.plan_resharding_expectations(plan))
    # a shard lives on the 2 ranks of its data group: 4 distinct blocks
    sharded = {f"params.{mod}.{leaf}": 4
               for mod, m in mlp.named_modules()
               if hasattr(m, "param_specs")
               for leaf, spec in m.param_specs().items()
               if any(a is not None for a in spec)}
    return trace_ranked(step, x, y, group=None,
                        mesh_axes={"data": 2, "model": 4},
                        sharded=sharded,
                        state=lambda: {"params": dict(
                            mlp.named_parameters())})


register_entry_point(
    "tp_mlp_train_step", tags=("training", "tp"), ranks=RANKS,
    description="DP x TP (2x4) ParallelMLP train step — Megatron "
                "all-reduce pattern + DDP grad bucket")(
    _tp_train_step_graph)
