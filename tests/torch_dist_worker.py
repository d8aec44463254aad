"""Rank worker for the port's multi-process CPU tests (gloo).

Run by the port's multi-rank test files (``tests/test_torch_syncbn.py``,
``tests/test_torch_ddp.py``, ``tests/test_torch_pipeline.py``, ...)
through the port's launcher::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 2 \\
        --init-method file:///tmp/.../store \\
        tests/torch_dist_worker.py SUITE INPUTS.pkl OUT_DIR

Each rank reads the numpy inputs the test made, runs every scenario of
SUITE (a key of ``SUITES``) on its share of the work, and writes its results as numpy arrays to ``OUT_DIR/SUITE-<rank>.pkl``.
It imports torch and apex_tpu_torch only: the tests hold the results
against the JAX package.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

from apex_tpu_torch import amp, models, nn, optimizers, parallel  # noqa: E402
from apex_tpu_torch.nn.functional import cross_entropy  # noqa: E402
from apex_tpu_torch.utils.jax_interop import params_from_jax  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _half(a: np.ndarray, rank: int, world: int) -> np.ndarray:
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


# -- suite "syncbn" -----------------------------------------------------------

def _syncbn(inp, rank, world):
    out = {}
    # output, running statistics and grads over the world
    x = torch.from_numpy(_half(inp["x"], rank, world)).requires_grad_()
    g = torch.from_numpy(_half(inp["g"], rank, world))
    sbn = parallel.SyncBatchNorm(inp["x"].shape[1], device="cpu")
    with torch.no_grad():
        sbn.weight.copy_(torch.from_numpy(inp["w"]))
        sbn.bias.copy_(torch.from_numpy(inp["b"]))
    y = sbn(x)
    (y * g).sum().backward()
    dw, db = sbn.weight.grad.clone(), sbn.bias.grad.clone()
    torch.distributed.all_reduce(dw)
    torch.distributed.all_reduce(db)
    out["sync"] = {"y": _np(y), "dx": _np(x.grad), "dw": _np(dw),
                   "db": _np(db), "running_mean": _np(sbn.running_mean),
                   "running_var": _np(sbn.running_var),
                   "num_batches_tracked": int(sbn.num_batches_tracked)}
    sbn.eval()
    out["sync"]["y_eval"] = _np(sbn(x))

    # two groups of one rank: each normalizes over its own half
    pg = parallel.create_syncbn_process_group(1)
    x2 = torch.from_numpy(_half(inp["x2"], rank, world))
    gbn = parallel.SyncBatchNorm(x2.shape[1], process_group=pg,
                                 device="cpu")
    out["groups"] = {"y": _np(gbn(x2)),
                     "running_mean": _np(gbn.running_mean),
                     "running_var": _np(gbn.running_var)}
    return out


# -- suite "ddp" --------------------------------------------------------------

class _Holder(torch.nn.Module):
    """Parameters with the given names, shapes and dtypes."""

    def __init__(self, spec):
        super().__init__()
        for name, (shape, dtype) in spec.items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.zeros(shape, dtype=DTYPES[dtype])))


def _bucket_case(case, rank):
    model = _Holder({k: (v.shape, case["dtypes"][k])
                     for k, v in case["grads"][rank].items()})
    ddp = parallel.DistributedDataParallel(model, **case["kwargs"])
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(case["grads"][rank][name]).to(p.dtype)
    ddp.allreduce_grads()
    return {"grads": {n: _np(p.grad) for n, p in model.named_parameters()},
            "grad_dtypes": {n: str(p.grad.dtype).replace("torch.", "")
                            for n, p in model.named_parameters()},
            "stats": ddp.last_comm_stats,
            "buffers": [_np(b) for b in ddp.allreduce_buffers]}


def _backward_case(inp, rank, world):
    """Grads reduced by the end-of-backward callback against each rank's
    local grads (the test averages the latter)."""
    x = torch.from_numpy(_half(inp["lin_x"], rank, world))
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(inp["lin_w"]))
        lin.bias.copy_(torch.from_numpy(inp["lin_b"]))
    local = torch.nn.Linear(4, 3)
    local.load_state_dict(lin.state_dict())
    (local(x) ** 2).sum().backward()
    ddp = parallel.DistributedDataParallel(lin)
    (ddp(x) ** 2).sum().backward()
    return {"local": {n: _np(p.grad) for n, p in local.named_parameters()},
            "reduced": {n: _np(p.grad) for n, p in lin.named_parameters()}}


def _collectives(rank):
    f = torch.full((2,), float(rank))
    h = torch.full((3,), float(rank) + 0.5).to(torch.bfloat16)
    sums = parallel.flat_dist_call([f.clone(), h.clone()], "sum")
    maxs = parallel.flat_dist_call([f.clone(), h.clone()], "max")
    bcast = parallel.flat_dist_call([f.clone() + 7, h.clone()], "broadcast")
    red = parallel.Reducer([torch.full((3,), float(rank))]).reduce()
    return {"sum": [_np(t) for t in sums], "max": [_np(t) for t in maxs],
            "broadcast": [_np(t) for t in bcast], "reducer": _np(red[0])}


def _amp_broadcast(rank):
    """Ranks start from different weights; DDP after amp.initialize leaves
    rank 0's masters, and a half copy derived from them, on every rank."""
    gen = torch.Generator().manual_seed(100 + rank)
    model = torch.nn.Sequential(
        nn.Conv2d(3, 4, 3, padding=1, bias=False, device="cpu",
                  generator=gen), nn.BatchNorm2d(4, device="cpu"))
    with torch.no_grad():
        model[1].weight.uniform_(0.5, 1.5, generator=gen)
    model, opt = amp.initialize(model, optimizers.FusedAdam(),
                                opt_level="O2", verbosity=0)
    parallel.DistributedDataParallel(model)
    m = opt.masters
    return {"masters": _np(m.buf), "half": _np(m.half),
            "half_dtype": str(m.half.dtype),
            "conv": _np(model[0].weight), "bn": _np(model[1].weight)}


def _slice(inp, rank, world):
    """ResNet [1,1,1,1] -> convert_syncbn_model -> O0 + FusedAdam -> DDP,
    trained on this rank's half of the batch."""
    model = models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                          device="cpu")
    model.load_state_dict(params_from_jax(inp["params"], inp["state"]))
    model = parallel.convert_syncbn_model(model)
    model, opt = amp.initialize(model,
                                optimizers.FusedAdam(lr=inp["lr"]),
                                opt_level="O0", verbosity=0)
    ddp = parallel.DistributedDataParallel(model)
    x = torch.from_numpy(_half(inp["x"], rank, world))
    y = torch.from_numpy(_half(inp["y"], rank, world))
    losses, adam = [], []
    for _ in range(inp["steps"]):
        loss = cross_entropy(ddp(x), y)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
        adam.append({"m": _np(opt.state.m), "v": _np(opt.state.v)})
    return {"losses": losses,
            "state_dict": {k: v.numpy().copy()
                           for k, v in model.state_dict().items()},
            "steps": int(opt.state.step), "adam": adam}


def _bert_lamb(inp, rank, world):
    """A tiny BertForPretraining -> O2 + FusedLAMB -> DDP (small
    ``message_size``: the bf16 bucket goes out in chunks), trained on this
    rank's half of the batch."""
    model = models.BertForPretraining(models.BertConfig(**inp["cfg"]),
                                      device="cpu")
    model.load_state_dict(params_from_jax(inp["params"]), strict=True)
    model, opt = amp.initialize(model, optimizers.FusedLAMB(lr=inp["lr"]),
                                opt_level="O2", verbosity=0)
    ddp = parallel.DistributedDataParallel(
        model, message_size=inp["message_size"])
    ids, labels, nsp, attn = (torch.from_numpy(_half(inp[k], rank, world))
                              for k in ("ids", "labels", "nsp", "attn"))
    losses = []
    for _ in range(inp["steps"]):
        loss = ddp.module.loss(ids, labels, nsp, attention_mask=attn)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    st = opt.state
    return {"losses": losses, "masters": _np(opt.masters.buf),
            "half": _np(opt.masters.half), "m": _np(st.m.buf),
            "v": _np(st.v.buf), "steps": int(st.step),
            "names": list(opt.masters.layout.names),
            "stats": ddp.last_comm_stats}


def _ddp(inp, rank, world):
    out = {"buckets": {name: _bucket_case(case, rank)
                       for name, case in inp["buckets"].items()}}
    out["backward"] = _backward_case(inp, rank, world)
    out["collectives"] = _collectives(rank)
    out["amp_broadcast"] = _amp_broadcast(rank)
    out["slice"] = _slice(inp["slice"], rank, world)
    out["bert_lamb"] = _bert_lamb(inp["bert_lamb"], rank, world)
    return out


# -- suite "make_step" --------------------------------------------------------

class _CountingAllReduce:
    """``torch.distributed.all_reduce`` that counts its calls."""

    def __init__(self):
        self.calls = 0
        self.inner = torch.distributed.all_reduce

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.inner(*args, **kwargs)


def _make_step(inp, rank, world):
    """ResNet [1,1,1,1] -> convert_syncbn_model -> O2 + FusedAdam -> DDP,
    trained through ``ddp.make_step`` on the functional step
    (``amp.scaled_grad``, ``ddp.allreduce_grads(grads)``,
    ``optimizer.step(grads)``) on this rank's half of the batch; with the
    collectives of each step counted and the end-of-backward hook
    watched."""
    model = models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                          device="cpu")
    model.load_state_dict(params_from_jax(inp["params"], inp["state"]))
    model = parallel.convert_syncbn_model(model)
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=inp["lr"]),
                                opt_level="O2", verbosity=0)
    ddp = parallel.DistributedDataParallel(model)
    hooked = []
    ddp._after_backward = lambda: hooked.append(1)
    counter = _CountingAllReduce()
    torch.distributed.all_reduce = counter

    def step(batch):
        x, y = batch
        loss, grads = amp.scaled_grad(lambda: cross_entropy(ddp(x), y), opt)
        grads = ddp.allreduce_grads(grads)
        info = opt.step(grads)
        mean = loss.clone()
        torch.distributed.all_reduce(mean)
        return {"loss": mean / world, "scale": info["loss_scale"].clone()}

    train = ddp.make_step(step)
    x = torch.from_numpy(_half(inp["x"], rank, world))
    y = torch.from_numpy(_half(inp["y"], rank, world))
    losses, calls = [], []
    try:
        for _ in range(inp["steps"]):
            before = counter.calls
            out = train((x, y))
            calls.append(counter.calls - before)
            losses.append(float(out["loss"]))
    finally:
        torch.distributed.all_reduce = counter.inner
    n_sync = sum(isinstance(m, parallel.SyncBatchNorm)
                 for m in model.modules())
    return {"losses": losses, "masters": _np(opt.masters.buf),
            "half": _np(opt.masters.half), "m": _np(opt.state.m),
            "v": _np(opt.state.v), "steps": int(opt.state.step),
            "buffers": {k: b.numpy().copy()
                        for k, b in model.named_buffers()},
            "grads_none": all(p.grad is None for p in model.parameters()),
            "hooked": len(hooked), "queued": ddp._queued,
            "all_reduce_calls": calls, "n_sync": n_sync,
            "plan": parallel.allreduce_comm_plan(
                dict(model.named_parameters())),
            "stats": ddp.last_comm_stats}


# -- suite "wide_ddp" (4 ranks: two "nodes" of two) ---------------------------

def _rank_grads(g, rank):
    return [torch.from_numpy(g) * (rank + 1)]


def _holder(shapes, dtype=torch.float32):
    return _Holder({f"p{i}": (s, {torch.float32: "float32",
                                  torch.bfloat16: "bfloat16"}[dtype])
                    for i, s in enumerate(shapes)})


def _reduce_with(grads, **kw):
    model = _holder([g.shape for g in grads], grads[0].dtype)
    ddp = parallel.DistributedDataParallel(model, **kw)
    out = ddp.allreduce_grads(grads)
    return [_np(t) for t in out], [str(t.dtype) for t in out], \
        ddp.last_comm_stats


def _hierarchical(inp, rank):
    out = {}
    g = inp["g1001"]
    out["flat"] = _reduce_with(_rank_grads(g, rank))[0]
    for ici in (2, 4, 1):
        out[f"h{ici}"] = _reduce_with(_rank_grads(g, rank),
                                      comm_topology="hierarchical",
                                      ici_size=ici)[0]
    g = inp["g512"]
    out["flat512"] = _reduce_with(_rank_grads(g, rank))[0]
    out["comp512"] = _reduce_with(_rank_grads(g, rank),
                                  comm_topology="hierarchical", ici_size=2,
                                  allreduce_compress_bf16=True)[0]
    bf = [torch.full((6,), 3.0, dtype=torch.bfloat16)]
    out["fp32comm"] = _reduce_with(bf, comm_topology="hierarchical",
                                   ici_size=2, allreduce_always_fp32=True)
    out["fp32comm_c"] = _reduce_with(bf, comm_topology="hierarchical",
                                     ici_size=2, allreduce_always_fp32=True,
                                     allreduce_compress_bf16=True)
    out["predivide"] = _reduce_with([torch.full((4,), 8.0)],
                                    comm_topology="hierarchical",
                                    ici_size=2,
                                    gradient_predivide_factor=4.0)[0]
    # mixed dtypes: a bucket a dtype, each through the two levels
    mixed = [torch.from_numpy(inp["g512"][:40]).to(torch.bfloat16) * rank,
             torch.from_numpy(inp["g1001"][:33]) * rank]
    model = _Holder({"a": ((40,), "bfloat16"), "b": ((33,), "float32")})
    for mode in ("flat", "hierarchical"):
        ddp = parallel.DistributedDataParallel(
            model, comm_topology=mode, ici_size=2 if mode != "flat" else None)
        red = ddp.allreduce_grads({"a": mixed[0], "b": mixed[1]})
        out[f"mixed_{mode}"] = {k: (_np(v), str(v.dtype))
                                for k, v in red.items()}
    stats = {}
    for name, kw in (("h", dict(comm_topology="hierarchical", ici_size=4)),
                     ("c", dict(message_size=100)),
                     ("hc", dict(comm_topology="hierarchical", ici_size=2,
                                 allreduce_compress_bf16=True)),
                     ("auto", dict(comm_topology="auto",
                                   allreduce_compress_bf16=True))):
        _, _, st = _reduce_with([torch.ones(310)], **kw)
        stats[name] = st
    out["stats"] = stats
    try:
        parallel.DistributedDataParallel(_holder([(4,)]),
                                         comm_topology="hierarchical",
                                         ici_size=3)
        out["bad_ici"] = None
    except ValueError as e:
        out["bad_ici"] = str(e)
    out["larc"] = _larc(inp, rank)
    return out


def _larc(inp, rank):
    """A small MLP under LARC over SGD, flat against hierarchical: the
    trust ratio reads the reduced grads alike (tests/test_ddp.py:440)."""
    x = torch.from_numpy(_half(inp["larc_x"], rank, 4))
    y = torch.from_numpy(_half(inp["larc_y"], rank, 4))
    res = {}
    for mode in ("flat", "hierarchical"):
        net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                                  torch.nn.Linear(8, 2))
        with torch.no_grad():
            for p, v in zip(net.parameters(), inp["larc_w"]):
                p.copy_(torch.from_numpy(v))
        ddp = parallel.DistributedDataParallel(
            net, comm_topology=mode, ici_size=2 if mode != "flat" else None)
        opt = parallel.LARC(optimizers.SGD(lr=0.05), trust_coefficient=0.02)
        flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
        from apex_tpu_torch.multi_tensor_apply import ChunkedFlatLayout
        layout = ChunkedFlatLayout(list(net.parameters()))
        state = opt.init(flat, layout)
        losses = []
        for _ in range(3):
            loss = ((net(x) - y) ** 2).mean()
            grads = torch.autograd.grad(loss, list(net.parameters()))
            names = [n for n, _ in net.named_parameters()]
            red = ddp.allreduce_grads(dict(zip(names, grads)))
            g = torch.cat([red[n].reshape(-1) for n in names])
            opt.step(flat, state, g)
            off = 0
            with torch.no_grad():
                for p in net.parameters():
                    p.copy_(flat[off:off + p.numel()].view(p.shape))
                    off += p.numel()
            mean = loss.detach().clone()
            torch.distributed.all_reduce(mean)
            losses.append(float(mean) / 4)
        res[mode] = {"losses": losses, "params": _np(flat)}
    return res


def _pair_groups():
    """Every rank makes every group, in one order."""
    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    pairs = [torch.distributed.new_group([2 * i, 2 * i + 1])
             for i in range(world // 2)]
    three = torch.distributed.new_group([0, 1, 2])
    return pairs[rank // 2], (three if rank < 3 else None)


def _adasum(inp, rank):
    from apex_tpu_torch.parallel import adasum_grads
    out = {}
    pair, three = _pair_groups()
    out["n4"] = _np(adasum_grads([torch.from_numpy(inp["ada4"][rank])])[0])
    out["n2"] = _np(adasum_grads([torch.from_numpy(inp["ada2"][rank % 2])],
                                 pair)[0])
    if three is not None:
        try:
            adasum_grads([torch.ones(4)], three)
            out["three"] = None
        except ValueError as e:
            out["three"] = str(e)
    g = torch.from_numpy(inp["ada_g"])
    for name, kw in (("wrapper", {}),
                     ("wrapper_h", dict(comm_topology="hierarchical",
                                        ici_size=2))):
        ddp = parallel.DistributedDataParallel(_holder([g.shape]),
                                               adasum=True, **kw)
        out[name] = (_np(ddp.allreduce_grads([g])[0]), ddp.last_comm_stats)
    sl = torch.from_numpy(inp["ada_slices"][rank // 2])
    out["slice_hier"] = _np(adasum_grads([sl], ici_size=2)[0])
    out["slice_flat"] = _np(adasum_grads([sl])[0])
    out["analytic"] = _np(adasum_grads(
        [torch.from_numpy(inp["ada_e"][rank])], ici_size=2)[0])
    out["one_slice"] = _np(adasum_grads([g], ici_size=4)[0])
    # the averaging property end to end: the same batch on every rank
    w = torch.from_numpy(inp["ada_w"]).requires_grad_()
    xb, yb = (torch.from_numpy(inp[k]) for k in ("ada_x", "ada_y"))
    (gw,) = torch.autograd.grad(((xb @ w - yb) ** 2).mean(), [w])
    out["train"] = _np(adasum_grads([gw])[0])
    return out


def _stage_fns(n):
    return [lambda p, a: torch.tanh(a @ p["w"] + p["b"])] * n


def _stage_params(inp):
    return [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
            for p in inp["stage_params"]]


def _staged(inp, rank):
    out = {}
    x = torch.from_numpy(_half(inp["stage_x"], rank, 4))
    y = torch.from_numpy(_half(inp["stage_y"], rank, 4))
    S = len(inp["stage_params"])

    def head(a):
        return ((a - y) ** 2).mean()

    def staged(overlap, compress=False, zero=False):
        ddp = parallel.DistributedDataParallel(
            _holder([(1,)]), comm_topology="hierarchical", ici_size=2,
            allreduce_compress_bf16=compress, overlap=overlap,
            zero_stage=2 if zero else None)
        params = _stage_params(inp)
        if zero:
            loss, new = ddp.staged_zero2_allreduce_grads(
                _stage_fns(S), head, params, x,
                lambda stage, p, g: p - 0.1 * g)
        else:
            loss, new = ddp.staged_allreduce_grads(_stage_fns(S), head,
                                                   params, x)
        return ([{k: _np(v) for k, v in g.items()} for g in new],
                float(loss), ddp.last_comm_stats, ddp.last_overlap_schedule)

    for name, kw in (("ov", dict(overlap=True)), ("ba", dict(overlap=False)),
                     ("cov", dict(overlap=True, compress=True)),
                     ("cba", dict(overlap=False, compress=True)),
                     ("z_ov", dict(overlap=True, zero=True)),
                     ("z_ba", dict(overlap=False, zero=True))):
        out[name] = staged(**kw)
    # the monolithic step: one backward, then one reduction of the tree
    params = _stage_params(inp)
    a = x
    for fn, p in zip(_stage_fns(S), params):
        a = fn(p, a)
    names = [f"{s}_{k}" for s in range(S) for k in ("w", "b")]
    leaves = [params[s][k] for s in range(S) for k in ("w", "b")]
    grads = torch.autograd.grad(head(a), leaves)
    ddp = parallel.DistributedDataParallel(
        _Holder({n: (t.shape, "float32") for n, t in zip(names, leaves)}),
        comm_topology="hierarchical", ici_size=2)
    red = ddp.allreduce_grads(dict(zip(names, grads)))
    out["mono"] = [{k: _np(red[f"{s}_{k}"]) for k in ("w", "b")}
                   for s in range(S)]
    errors = {}
    for name, kw, call in (
            ("delay", dict(delay_allreduce=True),
             lambda d: d.staged_allreduce_grads(_stage_fns(S), head,
                                                _stage_params(inp), x)),
            ("plain_zero2", dict(comm_topology="hierarchical", ici_size=2),
             lambda d: d.staged_zero2_allreduce_grads(
                 _stage_fns(S), head, _stage_params(inp), x,
                 lambda stage, p, g: p)),
            ("armed_allreduce", dict(comm_topology="hierarchical",
                                     ici_size=2, zero_stage=2),
             lambda d: d.allreduce_grads([torch.ones(1)]))):
        try:
            call(parallel.DistributedDataParallel(_holder([(1,)]), **kw))
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


class _Deep(torch.nn.Module):
    """Linear layers of several sizes and dtypes, one never used."""

    def __init__(self, dtype):
        super().__init__()
        g = torch.Generator().manual_seed(5)
        self.layers = torch.nn.ModuleList(
            [torch.nn.Linear(16, 16, dtype=dtype) for _ in range(5)])
        self.unused = torch.nn.Linear(3, 3, dtype=dtype)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def forward(self, x):
        for m in self.layers:
            x = torch.tanh(m(x))
        return x


def _hook_overlap(inp, rank):
    """The hook path with overlap=True against overlap=False: the same
    grads bitwise, for chunked flat buckets, hierarchical ones and the fp32
    comm of a bf16 model, with a parameter that gets no grad."""
    out = {}
    x = torch.from_numpy(_half(inp["deep_x"], rank, 4))
    for name, dtype, kw in (
            ("chunked", torch.float32, dict(message_size=100)),
            ("hier", torch.float32, dict(comm_topology="hierarchical",
                                         ici_size=2)),
            ("bf16_fp32comm", torch.bfloat16,
             dict(message_size=300, allreduce_always_fp32=True,
                  gradient_predivide_factor=2.0))):
        got = {}
        for overlap in (False, True):
            model = _Deep(dtype)
            ddp = parallel.DistributedDataParallel(model, overlap=overlap,
                                                   **kw)
            for _ in range(2):          # two backwards, the hook re-armed
                model.zero_grad(set_to_none=True)
                (ddp(x.to(dtype)) ** 2).sum().backward()
            got[overlap] = ({n: _np(p.grad) for n, p in
                             model.named_parameters() if p.grad is not None},
                            ddp.last_comm_stats,
                            model.unused.weight.grad is None)
        out[name] = got
    return out


def _mesh_groups():
    """Each rank's group along each axis of a 2 x 2 mesh."""
    mesh = parallel.make_mesh(data=-1, sp=2)
    return {axis: torch.distributed.get_process_group_ranks(
        mesh.group(axis)) for axis in ("data", "sp", ("data", "sp"))}


def _wide_ddp(inp, rank, world):
    return {"mesh": _mesh_groups(),
            "hier": _hierarchical(inp, rank), "adasum": _adasum(inp, rank),
            "staged": _staged(inp, rank),
            "hook_overlap": _hook_overlap(inp, rank)}


# -- suite "zero" (4 ranks; stages 2 and 3 over two "nodes" of two) -----------

class _ToyNode(torch.nn.Module):
    """Parameters named by a nested dict of arrays; a ``bn*`` node keeps
    fp32 parameters under O2."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, (_ToyNorm if k.startswith("bn")
                                    else _ToyNode)(v))
            else:
                self.register_parameter(k, torch.nn.Parameter(
                    torch.from_numpy(np.asarray(v, np.float32).copy())))


class _ToyNorm(_ToyNode):
    fp32_params = True


def _toy_pair(inp, **hp):
    return amp.initialize(_ToyNode(inp["toy"]),
                          optimizers.FusedAdam(lr=1e-3, weight_decay=0.01,
                                               **hp),
                          opt_level="O2", half_dtype="float16", verbosity=0)


def _toy_loss(named, g):
    return sum((p.float() * torch.from_numpy(g[n])).sum()
               for n, p in named.items())


def _zero_state(opt):
    st = opt.state_dict()
    return {"masters": _np(st["masters"]), "m": _np(st["inner"]["m"]),
            "v": _np(st["inner"]["v"]), "step": int(st["inner"]["step"]),
            "scalers": {k: v.numpy().copy()
                        for k, v in st["scalers"][0].items()},
            "half": None if opt.masters.half is None
            else _np(opt.masters.half)}


def _toy_steps(model, opt, grads, rank, stage=None, ddp=None):
    """Steps of the functional step on this rank's grads; returns each
    step's info."""
    infos = []
    for g in grads:
        g = g[rank]
        if stage == 3:
            loss, grad = amp.scaled_grad(
                lambda: _toy_loss(amp.zero_gather_params(opt), g), opt)
        else:
            loss, grad = amp.scaled_grad(
                lambda: _toy_loss(dict(model.named_parameters()), g), opt)
            if ddp is not None:
                grad = ddp.allreduce_grads(grad)
        info = opt.step(grad)
        infos.append({k: float(v) for k, v in info.items()})
    return infos


def _zero_toy(inp, rank):
    out = {}
    grads = inp["toy_grads"]
    K = inp["K"]
    for name, stage, kw in (("z1", 1, {}),
                            ("z2", 2, dict(zero_ici_size=2)),
                            ("z2c", 2, dict(zero_ici_size=2,
                                            zero_compress_bf16=True)),
                            ("z3", 3, dict(zero_ici_size=2)),
                            ("z1clip", 1, {}),
                            ("z2clip", 2, dict(zero_ici_size=2))):
        hp = ({"max_grad_norm": inp["clip"]} if name.endswith("clip")
              else {})
        model, opt = _toy_pair(inp, **hp)
        opt.zero_shard(zero_stage=stage, **kw)
        res = {"info": _toy_steps(model, opt, grads[:K], rank, stage)}
        res["at_k"] = _zero_state(opt)
        res["info"] += _toy_steps(model, opt, grads[K:], rank, stage)
        res["end"] = _zero_state(opt)
        res["params"] = {n: _np(p) for n, p in model.named_parameters()}
        out[name] = res
    # ZeRO-3 with the grads of two micro-batches accumulated a step
    model, opt = _toy_pair(inp)
    opt.zero_shard(zero_stage=3, zero_ici_size=2)
    res = {"info": []}
    for per in inp["toy_accum"]:
        mbs = {n: torch.from_numpy(a) for n, a in per[rank].items()}
        try:
            _, grad = amp.scaled_grad_accum(
                lambda mb: sum((p.float() * mb[n]).sum() for n, p in
                               amp.zero_gather_params(opt).items()),
                opt, mbs)
        except NotImplementedError as e:
            res["error"] = str(e)
            break
        info = opt.step(grad)
        res["info"].append({k: float(v) for k, v in info.items()})
    res["end"] = _zero_state(opt)
    out["z3accum"] = res
    # the same grads through the flat all-reduce (in fp32, as the sharded
    # step reduces them) and the unsharded step
    model, opt = _toy_pair(inp)
    ddp = parallel.DistributedDataParallel(model, allreduce_always_fp32=True)
    info = _toy_steps(model, opt, grads, rank, ddp=ddp)
    out["ddp"] = {"info": info, "masters": _np(opt.masters.buf),
                  "half": _np(opt.masters.half)}
    # a JAX ZeRO-1 state after K steps continues on the ranks
    from apex_tpu_torch.utils.jax_interop import zero_state_from_jax
    model, opt = _toy_pair(inp)
    opt.zero_shard()
    opt.load_state_dict(zero_state_from_jax(inp["jax_at_k"], rank, 4))
    info = _toy_steps(model, opt, grads[K:], rank)
    out["from_jax"] = {"info": info, "end": _zero_state(opt)}
    return out


class _Net(torch.nn.Sequential):
    """tests/test_zero.py's net: conv, BatchNorm, ReLU, flatten, linear."""

    def __init__(self):
        gen = torch.Generator().manual_seed(3)
        super().__init__(
            nn.Conv2d(3, 4, 3, padding=1, device="cpu", generator=gen),
            nn.BatchNorm2d(4, device="cpu"), nn.ReLU(), nn.Flatten(),
            nn.Linear(4 * 8 * 8, 10, device="cpu", generator=gen))


def _net_pair():
    return amp.initialize(_Net(), optimizers.FusedAdam(lr=1e-2),
                          opt_level="O2", verbosity=0)


def _net_steps(inp, rank, steps, stage=None, ddp_kw=None, zero_kw=None,
               grads_out=None):
    """``steps`` steps of the net on this rank's quarter of the batch;
    returns the mean losses, the gathered (or replicated) masters and the
    optimizer."""
    x = torch.from_numpy(_half(inp["net_x"], rank, 4))
    y = torch.from_numpy(_half(inp["net_y"], rank, 4)).long()
    model, opt = _net_pair()
    ddp = (parallel.DistributedDataParallel(model, **ddp_kw)
           if ddp_kw is not None else None)
    if stage is not None:
        opt.zero_shard(zero_stage=stage, **(zero_kw or {}))
    losses = []
    for _ in range(steps):
        if stage == 3:
            with amp.zero_gather_checkpoint_policy(opt):
                loss, g = amp.scaled_grad(lambda: cross_entropy(
                    torch.func.functional_call(
                        model, amp.zero_gather_params(opt), (x,)), y), opt)
        else:
            loss, g = amp.scaled_grad(lambda: cross_entropy(model(x), y),
                                      opt)
            if ddp is not None:
                g = ddp.allreduce_grads(g)
                if grads_out is not None:
                    grads_out.append([_np(t) for t in g])
        opt.step(g)
        mean = loss.detach().clone()
        torch.distributed.all_reduce(mean)
        losses.append(float(mean) / 4)
    if stage is None:
        masters = opt.masters.buf
    else:
        z = opt.masters.zero
        masters = torch.empty(z.padded)
        torch.distributed.all_gather_into_tensor(masters, opt.masters.buf,
                                                 group=z.group)
    return losses, _np(masters), opt


def _zero_net(inp, rank):
    out = {}
    grads_f, grads_h = [], []
    # the bf16 grads reduced in fp32, as the sharded step reduces them
    fp32 = dict(allreduce_always_fp32=True)
    out["ddp_1"] = _net_steps(inp, rank, 1, ddp_kw=fp32)[1]
    _net_steps(inp, rank, 1, ddp_kw={}, grads_out=grads_f)
    _net_steps(inp, rank, 1, ddp_kw=dict(comm_topology="hierarchical",
                                         ici_size=2), grads_out=grads_h)
    out["grads"] = (grads_f[0], grads_h[0])
    out["z1_1"] = _net_steps(inp, rank, 1, stage=1)[1]
    out["z2_1"] = _net_steps(inp, rank, 1, stage=2,
                             zero_kw=dict(zero_ici_size=2))[1]
    out["z2c_1"] = _net_steps(inp, rank, 1, stage=2,
                              zero_kw=dict(zero_ici_size=2,
                                           zero_compress_bf16=True))[1]
    losses, out["z3_1"], _ = _net_steps(inp, rank, 1, stage=3,
                                        zero_kw=dict(zero_ici_size=2))
    out["z3_loss"] = losses
    out["ddp_4"] = _net_steps(inp, rank, 4, ddp_kw=fp32)[0]
    out["hier_4"] = _net_steps(inp, rank, 4, ddp_kw=dict(
        comm_topology="hierarchical", ici_size=2, **fp32))[0]
    out["z1_4"] = _net_steps(inp, rank, 4, stage=1)[0]
    # make_step: the sharded update inside the step, two steps a call
    model, opt = _net_pair()
    opt.zero_shard()
    x = torch.from_numpy(_half(inp["net_x"], rank, 4))
    y = torch.from_numpy(_half(inp["net_y"], rank, 4)).long()

    def step(batch):
        xb, yb = batch
        loss, g = amp.scaled_grad(lambda: cross_entropy(model(xb), yb), opt)
        opt.step(g)
        mean = loss.clone()
        torch.distributed.all_reduce(mean)
        return mean / 4

    train = parallel.make_step(step, model, steps_per_call=2)
    kx, ky = torch.stack([x, x]), torch.stack([y, y])
    out["make_step"] = [_np(train((kx, ky))), _np(train((kx, ky)))]
    return out


def _zero_errors(inp, rank):
    errors = {}
    model, opt = _net_pair()
    opt.zero_shard(zero_stage=3, zero_ici_size=2)
    calls = (
        ("tree_grads", lambda: opt.step([torch.ones_like(p)
                                         for p in opt._params])),
        ("as_list", lambda: opt.masters.as_list()),
        ("write", lambda: opt.write_masters({})),
        ("scale_loss", lambda: opt._prepare_backward()),
        ("again", lambda: opt.zero_shard()),
        ("gather_stage1", lambda: amp.zero_gather_params(
            _zero1_opt())))
    for name, call in calls:
        try:
            call()
            errors[name] = None
        except (ValueError, RuntimeError) as e:
            errors[name] = str(e)
    real = torch.distributed.is_initialized
    torch.distributed.is_initialized = lambda: False
    try:
        opt.step(torch.zeros_like(opt.masters.buf))
        errors["outside"] = None
    except RuntimeError as e:
        errors["outside"] = str(e)
    finally:
        torch.distributed.is_initialized = real
    return errors


def _zero1_opt():
    _, opt = _net_pair()
    opt.zero_shard()
    return opt


def _zero(inp, rank, world):
    return {"toy": _zero_toy(inp, rank), "net": _zero_net(inp, rank),
            "errors": _zero_errors(inp, rank)}


# -- suite "tp" ---------------------------------------------------------------
#
# Four ranks as a (data 2 x model 2) grid, the JAX test mesh's device order:
# rank 2*d + m.  Each case builds its tensor-parallel module over the model
# group from the JAX package's full params, cut to this rank's shards.

def _grid_groups(rank):
    """(data group, model group, data index, model index) of ``rank``;
    every rank makes every group, in one order."""
    groups = {tuple(r): torch.distributed.new_group(r)
              for r in ([0, 1], [2, 3], [0, 2], [1, 3])}
    d, m = divmod(rank, 2)
    return groups[(m, m + 2)], groups[(2 * d, 2 * d + 1)], d, m


def _grad(p):
    """``p.grad`` as numpy; zeros for a parameter the loss does not
    reach (the JAX package's grad there)."""
    return _np(p.grad if p.grad is not None else torch.zeros_like(p))


def _gen():
    return torch.Generator().manual_seed(0)


def _tp_load(mod, params, index):
    from apex_tpu_torch.parallel.tensor_parallel import partition_specs
    from apex_tpu_torch.utils.jax_interop import tp_shard
    mod.load_state_dict(tp_shard(params_from_jax(params),
                                 partition_specs(mod), index, 2),
                        strict=True)
    return mod


def _fwd_grads(mod, *args, **kw):
    """Output, input grad and parameter grads of ``sum(out**2)``."""
    x = torch.from_numpy(args[0]).requires_grad_()
    y = mod(x, *[torch.from_numpy(a) for a in args[1:]], **kw)
    (y.float() ** 2).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad),
            "grads": {n: _grad(p) for n, p in mod.named_parameters()}}


def _tp_layers(inp, model, m):
    from apex_tpu_torch.nn import functional as F
    from apex_tpu_torch.parallel import tensor_parallel as tpl
    out = {}
    kw = dict(axis_name=model, device="cpu", generator=_gen())
    for name, mk in (
            ("mlp_gelu", lambda: tpl.ParallelMLP(16, 64, **kw)),
            ("mlp_relu", lambda: tpl.ParallelMLP(8, 32, activation="relu",
                                                 **kw)),
            ("col_gather", lambda: tpl.ColumnParallelLinear(
                8, 16, gather_output=True, **kw)),
            ("row_scatter", lambda: tpl.RowParallelLinear(
                16, 8, input_is_parallel=False, **kw)),
            ("attn_full", lambda: tpl.ParallelSelfAttention(32, 8, **kw)),
            ("attn_causal", lambda: tpl.ParallelSelfAttention(
                32, 8, causal=True, **kw)),
            ("attn_gqa_rope", lambda: tpl.ParallelSelfAttention(
                32, 8, causal=True, num_kv_heads=2, rope_theta=10000.0,
                bias=False, **kw)),
            ("attn_mask", lambda: tpl.ParallelSelfAttention(32, 8, **kw))):
        case = inp[name]
        mod = _tp_load(mk(), case["params"], m)
        args = [case["x"]] + ([case["mask"]] if "mask" in case else [])
        out[name] = _fwd_grads(mod, *args)
    # the vocab-parallel embedding: output and the table's grad
    emb = _tp_load(tpl.VocabParallelEmbedding(32, 16, **kw),
                   inp["emb"]["params"], m)
    y = emb(torch.from_numpy(inp["emb"]["ids"]))
    (y ** 2).sum().backward()
    out["emb"] = {"y": _np(y), "grads": {"weight": _np(emb.weight.grad)}}
    # the same lookup from an int8 table: each rank quantizes its block
    from apex_tpu_torch import quantization
    q = quantization.quantize(emb.weight.detach(), dtype=torch.float32)
    del emb.weight
    emb.weight = q
    out["qemb"] = _np(emb(torch.from_numpy(inp["emb"]["ids"])))
    # the cross-entropy over vocab-sharded logits
    lg = torch.from_numpy(np.ascontiguousarray(
        inp["xent"]["logits"][..., m * 16:(m + 1) * 16])).requires_grad_()
    loss = tpl.vocab_parallel_cross_entropy(
        lg, torch.from_numpy(inp["xent"]["labels"]), axis_name=model)
    loss.backward()
    out["xent"] = {"loss": float(loss.detach()), "dlogits": _np(lg.grad)}

    # embedding -> MLP -> column head -> vocab-parallel loss
    class TinyLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = tpl.VocabParallelEmbedding(32, 16, **kw)
            self.mlp = tpl.ParallelMLP(16, 32, **kw)
            self.head = tpl.ColumnParallelLinear(16, 32, bias=False, **kw)

        def forward(self, ids, labels):
            h = self.emb(ids)
            h = h + self.mlp(h)
            return tpl.vocab_parallel_cross_entropy(self.head(h), labels,
                                                    axis_name=model)

    lm = _tp_load(TinyLM(), inp["lm"]["params"], m)
    loss = lm(torch.from_numpy(inp["lm"]["ids"]),
              torch.from_numpy(inp["lm"]["labels"]))
    loss.backward()
    out["lm"] = {"loss": float(loss.detach()),
                 "grads": {n: _grad(p) for n, p in lm.named_parameters()}}
    # six heads over two ranks: the divisibility error
    try:
        tpl.ParallelSelfAttention(12, 3, **kw)
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)
    # dropout: each rank of the group its own mask, the generator in step
    gen = _gen()
    attn = tpl.ParallelSelfAttention(32, 8, dropout=0.5, axis_name=model,
                                     device="cpu", generator=_gen(),
                                     dropout_generator=gen)
    _tp_load(attn, inp["attn_full"]["params"], m)
    x = torch.from_numpy(inp["attn_full"]["x"])
    with torch.no_grad():
        y_train = attn(x)
        attn.eval()
        y_eval = attn(x)
    mask = F.dropout(torch.ones(64), 0.5, gen, (m, 2)) != 0
    masks = [torch.zeros(64, dtype=torch.bool) for _ in range(2)]
    torch.distributed.all_gather(masks, mask, group=model)
    out["dropout"] = {"finite": bool(torch.isfinite(y_train).all()),
                      "train_vs_eval": float((y_train - y_eval).abs().max()),
                      "masks_differ": not torch.equal(masks[0], masks[1]),
                      "next_draw": float(torch.rand(1, generator=gen))}
    return out


def _tp_models(inp, model, m):
    out = {}
    kw = dict(device="cpu")
    for name, build, args in (
            ("bert", lambda: models.BertForPretraining(models.BertConfig(
                tp_axis=model, **inp["bert"]["cfg"]), **kw),
             ("ids", "mlm", "nsp")),
            ("gpt", lambda: models.GPT(models.GPTConfig(
                tp_axis=model, **inp["gpt"]["cfg"]), **kw), ("ids",)),
            ("llama", lambda: models.Llama(models.LlamaConfig(
                tp_axis=model, **inp["llama"]["cfg"]), **kw), ("ids",))):
        case = inp[name]
        mod = build()
        if name == "llama":
            # a dense model's weights through llama_params_to_tp
            from apex_tpu_torch.parallel.tensor_parallel import \
                partition_specs
            from apex_tpu_torch.utils.jax_interop import tp_shard
            full = models.llama_params_to_tp(params_from_jax(case["params"]))
            mod.load_state_dict(tp_shard(full, partition_specs(mod), m, 2))
        else:
            _tp_load(mod, case["params"], m)
        loss = mod.loss(*[torch.from_numpy(case[a]) for a in args])
        loss.backward()
        out[name] = {"loss": float(loss.detach()),
                     "grads": {n: _grad(p)
                               for n, p in mod.named_parameters()}}
        if name == "gpt":
            with torch.no_grad():
                ids, n = mod.generate(torch.from_numpy(case["buf"]), 5, 6)
            out["gpt_generate"] = ids.numpy()
    return out


def _tp_grid(inp, data, model, d, m):
    """Tiny BERT under O2 + FusedAdam on the grid: the batch split over
    data, grads averaged over it, the overflow flag merged over model."""
    case = inp["grid"]
    mod, opt = amp.initialize(
        models.BertForPretraining(models.BertConfig(
            tp_axis=model, **case["cfg"]), device="cpu"),
        optimizers.FusedAdam(lr=2e-3), opt_level="O2", verbosity=0)
    _tp_load(mod, case["params"], m)
    opt.refresh_masters()
    ids, mlm, nsp = (torch.from_numpy(_half(case[k], d, 2))
                     for k in ("ids", "mlm", "nsp"))
    losses = []
    for _ in range(case["steps"]):
        loss, grads = amp.scaled_grad(lambda: mod.loss(ids, mlm, nsp), opt)
        for g in grads:
            torch.distributed.all_reduce(g, group=data)
            g /= 2
        info = opt.step(grads, found_inf_axes=(model,))
        loss = loss.clone()
        torch.distributed.all_reduce(loss, group=data)
        losses.append(float(loss.detach()) / 2)
    return {"losses": losses, "scale": float(info["loss_scale"])}


def _tp_overflow(inp, model, m):
    from apex_tpu_torch.parallel import tensor_parallel as tpl
    out = {}
    for merge in (True, False):
        col, opt = amp.initialize(
            tpl.ColumnParallelLinear(8, 16, bias=False, axis_name=model,
                                     device="cpu", generator=_gen()),
            optimizers.FusedAdam(lr=0.1), opt_level="O2", verbosity=0,
            hard_override=True)
        _tp_load(col, inp["overflow"]["params"], m)
        opt.refresh_masters()
        w0 = _np(opt.masters.buf)
        g = torch.from_numpy(inp["overflow"]["g"][m * 8:(m + 1) * 8])
        info = opt.step([g], found_inf_axes=(model,) if merge else None)
        out[merge] = {"w0": w0, "w1": _np(opt.masters.buf),
                      "found_inf": float(info["found_inf"]),
                      "loss_scale": float(info["loss_scale"])}
    return out


def _mlp_pair(model, params, m, state=None):
    from apex_tpu_torch.parallel import tensor_parallel as tpl
    mlp, opt = amp.initialize(
        tpl.ParallelMLP(8, 32, activation="relu", axis_name=model,
                        device="cpu", generator=_gen()),
        optimizers.FusedAdam(lr=1e-2), opt_level="O2",
        cast_model_type=torch.float32, verbosity=0, hard_override=True)
    _tp_load(mlp, params, m)
    opt.refresh_masters()
    if state is not None:
        opt.load_state_dict(state)
    return mlp, opt


def _mlp_steps(mlp, opt, x, y, n, model):
    from apex_tpu_torch.nn import functional as F
    losses = []
    for _ in range(n):
        loss, g = amp.scaled_grad(lambda: F.mse_loss(mlp(x), y), opt)
        opt.step(g, found_inf_axes=(model,))
        losses.append(float(loss.detach()))
    return losses


def _tp_state(inp, model, m, rank, tmp_dir):
    """A checkpoint round trip of the TP state, and a JAX state continued
    on the ranks."""
    from apex_tpu_torch.utils import checkpoint as ckpt
    from apex_tpu_torch.utils.jax_interop import zero_state_from_jax
    case = inp["state"]
    x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
    mlp, opt = _mlp_pair(model, case["params"], m)
    _mlp_steps(mlp, opt, x, y, 3, model)
    path = os.path.join(tmp_dir, f"tp-ckpt-{rank}")
    tree = {"model": dict(mlp.state_dict()), "opt": opt.state_dict()}
    ckpt.save_checkpoint(path, 3, tree)
    mlp2, opt2 = _mlp_pair(model, case["params"], m)
    back = ckpt.restore_checkpoint(
        path, {"model": dict(mlp2.state_dict()), "opt": opt2.state_dict()})
    mlp2.load_state_dict(back["model"])
    opt2.load_state_dict(back["opt"])
    out = {"traj_a": _mlp_steps(mlp, opt, x, y, 3, model),
           "traj_b": _mlp_steps(mlp2, opt2, x, y, 3, model),
           "at_6": _zero_state(opt)}
    # the JAX package's state after 3 steps, continued here for 3
    # (loading the masters rewrites the half params from them)
    mlp3, opt3 = _mlp_pair(model, case["params"], m,
                           zero_state_from_jax(case["jax_at_3"], m, 2))
    out["from_jax"] = {"losses": _mlp_steps(mlp3, opt3, x, y, 3, model),
                       "end": _zero_state(opt3)}
    return out


def _tp(inp, rank, world):
    data, model, d, m = _grid_groups(rank)
    return {"layers": _tp_layers(inp, model, m),
            "models": _tp_models(inp, model, m),
            "grid": _tp_grid(inp, data, model, d, m),
            "overflow": _tp_overflow(inp, model, m),
            "state": _tp_state(inp, model, m, rank, inp["tmp_dir"])}


# -- suite "ep" ---------------------------------------------------------------

def _ep(inp, rank, world):
    from apex_tpu_torch.parallel import expert_parallel as epl
    from apex_tpu_torch.parallel.tensor_parallel import partition_specs
    from apex_tpu_torch.utils.jax_interop import tp_shard
    group = torch.distributed.group.WORLD
    out = {}
    for name, kw in (("switch", dict(capacity_factor=2.0)),
                     ("top2", dict(capacity_factor=2.0, top_k=2,
                                   expert_type="swiglu"))):
        case = inp[name]
        moe = epl.ExpertParallelMLP(8, 16, 8, axis_name=group, device="cpu",
                                    generator=_gen(), **kw)
        moe.load_state_dict(tp_shard(params_from_jax(case["params"]),
                                     partition_specs(moe), rank, world))
        x = torch.from_numpy(_half(case["x"], rank, world))
        y = moe(x)
        (y ** 2).sum().backward()
        grads = {n: p.grad for n, p in moe.named_parameters()}
        # the router routed this rank's tokens only: sum its grad
        grads = epl.allreduce_replicated_grads(grads, partition_specs(moe),
                                               group)
        out[name] = {"y": _np(y), "grads": {n: _np(g)
                                            for n, g in grads.items()}}
    try:
        epl.ExpertParallelMLP(8, 16, 3, axis_name=group, device="cpu",
                              generator=_gen())
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)
    # Mixtral with ep_axis: logits and the loss's grads, replicated
    # leaves summed by allreduce_replicated_grads
    case = inp["mixtral"]
    mx = models.Mixtral(models.MixtralConfig(ep_axis=group, **case["cfg"]),
                        device="cpu")
    specs = partition_specs(mx)
    mx.load_state_dict(tp_shard(params_from_jax(case["params"]), specs,
                                rank, world))
    ids = torch.from_numpy(_half(case["ids"], rank, world))
    with torch.no_grad():
        logits = mx(ids)
    mx.loss(ids).backward()
    grads = epl.allreduce_replicated_grads(
        {n: p.grad for n, p in mx.named_parameters()}, specs, group)
    out["mixtral"] = {"logits": _np(logits),
                      "grads": {n: _np(g) for n, g in grads.items()}}
    return out


# -- suite "pp" ---------------------------------------------------------------
#
# Four ranks: one pipeline of four stages over the world, and as a (pp 2 x
# data 2) or (pp 2 x model 2) grid, the JAX test meshes' device order: rank
# 2*p + j, its pipeline group the ranks of its column, its data (or model)
# group the ranks of its row.

class _PPBlock(torch.nn.Module):
    """tests/test_pipeline.py's stage: x + fc2(gelu(fc1(x)))."""

    def __init__(self, width):
        super().__init__()
        self.fc1 = nn.Linear(width, 2 * width, device="cpu", generator=_gen())
        self.fc2 = nn.Linear(2 * width, width, device="cpu", generator=_gen())

    def forward(self, x):
        from apex_tpu_torch.nn import functional as F
        return x + self.fc2(F.gelu(self.fc1(x)))


class _PPTPBlock(torch.nn.Module):
    """tests/test_pipeline.py's TPBlock: column -> gelu -> row."""

    def __init__(self, width, model):
        super().__init__()
        from apex_tpu_torch.parallel import tensor_parallel as tpl
        kw = dict(axis_name=model, device="cpu", generator=_gen())
        self.col = tpl.ColumnParallelLinear(width, 2 * width, **kw)
        self.row = tpl.RowParallelLinear(2 * width, width, **kw)

    def forward(self, x):
        from apex_tpu_torch.nn import functional as F
        return x + self.row(F.gelu(self.col(x)))


def _pp_groups():
    """Every group of the suite, made on every rank in one order."""
    return {tuple(r): torch.distributed.new_group(r)
            for r in ([0, 1], [2, 3], [0, 2], [1, 3])}


def _stages(make, stacked, group, index=None, model_index=None):
    """An ``init_stacked`` pipeline over ``group`` holding the JAX
    package's stacked params of this rank's stage (cut to its
    tensor-parallel shards by ``model_index``)."""
    from apex_tpu_torch.parallel import pipeline as pp
    from apex_tpu_torch.parallel.tensor_parallel import partition_specs
    from apex_tpu_torch.utils.jax_interop import stacked_from_jax, tp_shard
    S = jax_len(stacked)
    st = pp.init_stacked(make, S, group)
    sd = stacked_from_jax(stacked, st.stage_ids)
    if model_index is not None:
        sd = tp_shard(sd, partition_specs(st), model_index, 2)
    st.load_state_dict(sd, strict=True)
    return st


def jax_len(tree):
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _mse(y, t):
    return ((y - t) ** 2).mean()


def _pp_apply(inp, world_group):
    from apex_tpu_torch.parallel import pipeline as pp
    out = {}
    for name in ("gpipe_4", "gpipe_7"):
        case = inp[name]
        st = _stages(lambda: _PPBlock(16), case["stacked"], world_group)
        x = torch.from_numpy(case["x"]).requires_grad_()
        y = pp.pipeline_apply(st, x, world_group)
        (y ** 2).mean().backward()
        out[name] = {"y": _np(y), "dx": _np(x.grad),
                     "grads": {n: _grad(p) for n, p in st.named_parameters()}}
    return out


def _pp_gpipe_dp(inp, rank, groups):
    """GPipe on the (pp 2 x data 2) grid: each data rank's half of every
    microbatch's batch."""
    from apex_tpu_torch.parallel import pipeline as pp
    case = inp["gpipe_dp"]
    p, d = divmod(rank, 2)
    st = _stages(lambda: _PPBlock(8), case["stacked"], groups[(d, d + 2)])
    x = torch.from_numpy(np.ascontiguousarray(case["x"][:, 2 * d:2 * d + 2]))
    with torch.no_grad():
        return _np(pp.pipeline_apply(st, x, groups[(d, d + 2)]))


def _pp_1f1b(inp, rank, world_group, groups):
    from apex_tpu_torch.parallel import pipeline as pp
    out = {}
    for name, case in inp["grid"].items():
        S = case["S"]
        # S = 2 runs on the two column groups, each its own pipeline
        group = world_group if S == 4 else groups[(rank % 2, rank % 2 + 2)]
        st = _stages(lambda: _PPBlock(8), case["stacked"], group)
        loss, grads = pp.pipeline_1f1b_grads(
            st, _mse, torch.from_numpy(case["x"]),
            torch.from_numpy(case["t"]), group)
        out[name] = {"loss": _np(loss), "grads": {n: _np(g) for n, g in
                                                  grads.items()},
                     "stage": st.stage_ids[0]}
    return out


def _pp_o2(inp, rank, groups):
    """1F1B on the (pp 2 x data 2) grid under O2 + FusedAdam: one step on
    each data rank's half of every microbatch, the grads averaged over
    data; then a step with an inf in the input, which every rank skips."""
    from apex_tpu_torch.parallel import pipeline as pp
    case = inp["o2"]
    p, d = divmod(rank, 2)
    pp_group, data = groups[(d, d + 2)], groups[(2 * p, 2 * p + 1)]
    st = _stages(lambda: _PPBlock(8), case["stacked"], pp_group)
    st, opt = amp.initialize(st, optimizers.FusedAdam(lr=1e-2),
                             opt_level="O2", verbosity=0)

    def step(x, t):
        scale = opt.scalers[0].loss_scale
        loss, g = pp.pipeline_1f1b_grads(
            st, lambda y, tt: _mse(y.float(), tt) * scale, x, t, pp_group)
        for k, v in g.items():
            v32 = v.float()
            torch.distributed.all_reduce(v32, group=data)
            g[k] = (v32 / 2).to(v.dtype)
        torch.distributed.all_reduce(loss, group=data)
        info = opt.step(g)
        return float(loss / 2 / scale), {k: float(v)
                                          for k, v in info.items()}

    x = torch.from_numpy(np.ascontiguousarray(case["x"][:, 2 * d:2 * d + 2]))
    t = torch.from_numpy(np.ascontiguousarray(case["t"][:, 2 * d:2 * d + 2]))
    loss1, info1 = step(x, t)
    p1 = {n: _np(q) for n, q in st.named_parameters()}
    bad = x.clone()
    if d == 0:
        bad[0, 0, 0] = float("inf")
    _, info2 = step(bad, t)
    p2 = {n: _np(q) for n, q in st.named_parameters()}
    return {"loss": loss1, "info1": info1, "info2": info2, "p1": p1,
            "p2": p2, "skipped": int(opt.scalers[0].steps_skipped),
            "stage": st.stage_ids[0]}


def _pp_train(inp, world_group):
    """25 steps through the 1F1B schedule with FusedAdam (O0)."""
    from apex_tpu_torch.parallel import pipeline as pp
    case = inp["train"]
    st = _stages(lambda: _PPBlock(8), case["stacked"], world_group)
    st, opt = amp.initialize(st, optimizers.FusedAdam(lr=3e-3),
                             opt_level="O0", verbosity=0)
    x, t = torch.from_numpy(case["x"]), torch.from_numpy(case["t"])
    losses = []
    for _ in range(case["steps"]):
        loss, g = pp.pipeline_1f1b_grads(st, _mse, x, t, world_group)
        opt.step(g)
        losses.append(float(loss))
    return losses


def _pp_tp(inp, rank, groups):
    """Both schedules with the TP stage on the (pp 2 x model 2) grid."""
    from apex_tpu_torch.parallel import pipeline as pp
    case = inp["tp"]
    p, m = divmod(rank, 2)
    pp_group, model = groups[(m, m + 2)], groups[(2 * p, 2 * p + 1)]

    def stages():
        return _stages(lambda: _PPTPBlock(8, model), case["stacked"],
                       pp_group, model_index=m)

    st = stages()
    x = torch.from_numpy(case["x"])
    y = pp.pipeline_apply(st, x, pp_group)
    (y ** 2).mean().backward()
    out = {"y": _np(y), "grads": {n: _grad(q) for n, q in
                                  st.named_parameters()},
           "stage": st.stage_ids[0], "model": m}
    st = stages()
    loss, grads = pp.pipeline_1f1b_grads(st, _mse, x,
                                         torch.from_numpy(case["t"]),
                                         pp_group)
    out["1f1b"] = {"loss": float(loss),
                   "grads": {n: _np(g) for n, g in grads.items()}}
    return out


def _pp(inp, rank, world):
    groups = _pp_groups()
    wg = torch.distributed.group.WORLD
    return {"apply": _pp_apply(inp, wg),
            "gpipe_dp": _pp_gpipe_dp(inp, rank, groups),
            "grid": _pp_1f1b(inp, rank, wg, groups),
            "o2": _pp_o2(inp, rank, groups),
            "train": _pp_train(inp, wg),
            "tp": _pp_tp(inp, rank, groups)}


# -- suite "sp" ---------------------------------------------------------------
#
# Four ranks: the world as one sequence-parallel group (rank i holds tokens
# [i*T/4, (i+1)*T/4)), and as an (sp 2 x model 2) grid, rank 2*s + m.

def _seq_slice(a, rank, n, axis):
    b = a.shape[axis] // n
    return np.ascontiguousarray(np.take(a, np.arange(rank * b, (rank + 1) * b),
                                        axis=axis))


def _sp_attention(inp, rank, g):
    from apex_tpu_torch.transformer import ring_attention, ulysses_attention
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    case = inp["attn"]
    q, k, v = (_seq_slice(case[n], rank, 4, 2) for n in "qkv")
    mask = _seq_slice(case["mask"], rank, 4, 1)
    out = {}
    for key in case["keys"]:
        fn, causal, masked, remat = key.split("_")
        kw = dict(causal=causal == "causal",
                  kv_mask=torch.from_numpy(mask) if masked == "mask"
                  else None)
        if fn == "ring":
            kw["remat"] = remat == "remat"
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        y = fns[fn](*ts, axis_name=g, **kw)
        (y ** 2).sum().backward()
        out[key] = {"y": _np(y), "dq": _np(ts[0].grad),
                    "dk": _np(ts[1].grad), "dv": _np(ts[2].grad)}
    # bf16: ring against Ulysses, causal
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out["bf16"] = {f: _np(fns[f](qb, kb, vb, axis_name=g, causal=True))
                   for f in fns}
    # the head-count check
    try:
        ulysses_attention(*(torch.zeros(1, 6, 2, 4) for _ in range(3)),
                          axis_name=g)
        out["heads"] = None
    except ValueError as e:
        out["heads"] = str(e)
    return out


def _sp_dropout(inp, rank, g):
    """Ring and Ulysses attention dropout: live, deterministic given the
    generator, and the remat'd backward reads the forward's masks."""
    from apex_tpu_torch.transformer import ring_attention, ulysses_attention
    case = inp["attn"]
    q, k, v = (_seq_slice(case[n], rank, 4, 2) for n in "qkv")

    def ring(seed, remat, rate=0.5):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        y = ring_attention(*ts, axis_name=g, causal=True, remat=remat,
                           dropout_rate=rate,
                           dropout_generator=torch.Generator().manual_seed(
                               seed) if rate else None)
        (y ** 2).sum().backward()
        return [y.detach()] + [t.grad for t in ts]

    a, b, c = ring(1, True), ring(1, False), ring(2, True)
    plain = ring(0, True, rate=0.0)
    # the mask over the whole sequence is the flash route's for the same
    # seed words: the plain flash forward of the full q, k, v, this
    # rank's rows
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.transformer.attention import _draw_seed
    B, H, T, D = case["q"].shape
    full = [torch.from_numpy(case[n]).reshape(B * H, T, D) for n in "qkv"]
    words = _draw_seed(torch.Generator().manual_seed(1), "cpu")
    o, _ = fa._fwd_plain(*full, H, D ** -0.5, True, None, None, words, 0.5)
    o = o.reshape(B, H, T, D)[:, :, rank * (T // 4):(rank + 1) * (T // 4)]
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    u = [ulysses_attention(*ts, axis_name=g, causal=True, dropout_rate=0.5,
                           dropout_generator=torch.Generator().manual_seed(
                               s)) for s in (1, 1, 2)]
    u0 = ulysses_attention(*ts, axis_name=g, causal=True)
    return {"remat_bitwise": all(torch.equal(x, y) for x, y in zip(a, b)),
            "seed_differs": not torch.equal(a[0], c[0]),
            "live": float((a[0] - plain[0]).abs().max()),
            "flash_mask": float((a[0] - o).abs().max()),
            "finite": bool(all(torch.isfinite(x).all() for x in a)),
            "ulysses_same_seed": torch.equal(u[0], u[1]),
            "ulysses_seed_differs": not torch.equal(u[0], u[2]),
            "ulysses_live": float((u[0] - u0).abs().max())}


def _sp_models(inp, rank, g):
    out = {}
    for name in ("gpt", "llama", "bert"):
        case = inp[name]
        if name == "gpt":
            mod = models.GPT(models.GPTConfig(sp_axis=g, **case["cfg"]),
                             device="cpu")
        elif name == "llama":
            mod = models.Llama(models.LlamaConfig(sp_axis=g, **case["cfg"]),
                               device="cpu")
        else:
            mod = models.BertForPretraining(models.BertConfig(
                sp_axis=g, **case["cfg"]), device="cpu")
        mod.load_state_dict(params_from_jax(case["params"]), strict=True)
        args = [torch.from_numpy(_seq_slice(case["ids"], rank, 4, 1))]
        kw = {}
        if name == "bert":
            args += [torch.from_numpy(_seq_slice(case["mlm"], rank, 4, 1)),
                     torch.from_numpy(case["nsp"])]
            kw["attention_mask"] = torch.from_numpy(
                _seq_slice(case["amask"], rank, 4, 1))
        loss = mod.loss(*args, **kw)
        loss.backward()
        grads = {}
        for n, p in mod.named_parameters():
            t = p.grad if p.grad is not None else torch.zeros_like(p)
            torch.distributed.all_reduce(t, group=g)
            grads[n] = _np(t / 4)
        res = {"loss": float(loss.detach()), "grads": grads}
        if name != "bert":
            # attention_mask under sp is refused, in the loss and forward
            try:
                mod.loss(args[0], torch.ones_like(args[0]))
                res["mask_refusal"] = None
            except NotImplementedError as e:
                res["mask_refusal"] = str(e)
        out[name] = res
    # GPT's attention dropout is live on the ring path in train mode
    case = inp["gpt"]
    ids = torch.from_numpy(_seq_slice(case["ids"], rank, 4, 1))
    outs = []
    for seed in (0, 1):
        gpt = models.GPT(models.GPTConfig(sp_axis=g, **dict(
            case["cfg"], dropout=0.3)), device="cpu",
            dropout_generator=torch.Generator().manual_seed(seed))
        gpt.load_state_dict(params_from_jax(case["params"]))
        with torch.no_grad():
            outs.append(gpt(ids))
    out["gpt_dropout"] = float((outs[0] - outs[1]).abs().max())
    return out


class _Block3D(torch.nn.Module):
    """tests/test_tensor_parallel.py's 3-axis block: ring attention over
    the sequence group, Megatron column/row layers over the model group."""

    def __init__(self, sp, model, E=16, H=4):
        super().__init__()
        from apex_tpu_torch.parallel import tensor_parallel as tpl
        kw = dict(axis_name=model, device="cpu", generator=_gen())
        self.q = tpl.ColumnParallelLinear(E, E, input_grad_reduce=False, **kw)
        self.k = tpl.ColumnParallelLinear(E, E, input_grad_reduce=False, **kw)
        self.v = tpl.ColumnParallelLinear(E, E, input_grad_reduce=False, **kw)
        self.out = tpl.RowParallelLinear(E, E, **kw)
        self.mlp = tpl.ParallelMLP(E, 2 * E, activation="relu", **kw)
        self.sp, self.model, self.H = sp, model, H

    def forward(self, x):
        from apex_tpu_torch.parallel import tensor_parallel as tpl
        from apex_tpu_torch.transformer import ring_attention
        B, T, E = x.shape
        hl = self.H // tpl.axis_size(self.model)
        D = E // self.H
        xf = tpl.copy_to_model_parallel(x, self.model)
        q, k, v = (lin(xf).reshape(B, T, hl, D).transpose(1, 2)
                   for lin in (self.q, self.k, self.v))
        ctx = ring_attention(q, k, v, axis_name=self.sp)
        x = x + self.out(ctx.transpose(1, 2).reshape(B, T, hl * D))
        return x + self.mlp(x)


def _sp_3d(inp, rank, groups):
    from apex_tpu_torch.parallel.tensor_parallel import partition_specs
    from apex_tpu_torch.utils.jax_interop import tp_shard
    s, m = divmod(rank, 2)
    sp, model = groups[(m, m + 2)], groups[(2 * s, 2 * s + 1)]
    case = inp["block3d"]
    blk = _Block3D(sp, model)
    blk.load_state_dict(tp_shard(params_from_jax(case["params"]),
                                 partition_specs(blk), m, 2))
    x = torch.from_numpy(_seq_slice(case["x"], s, 2, 1))
    y = blk(x)
    (y ** 2).sum().backward()
    grads = {}
    for n, p in blk.named_parameters():
        t = p.grad.clone()
        torch.distributed.all_reduce(t, group=sp)
        grads[n] = _np(t)
    return {"y": _np(y), "grads": grads, "s": s, "m": m}


def _sp_example(inp):
    """The long-context example at dp 2 x sp 2, both strategies."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples", "long_context", "train_sp_torch.py")
    spec = importlib.util.spec_from_file_location("train_sp_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return {strategy: example.main(inp["example_argv"]
                                   + ["--strategy", strategy])["losses"]
            for strategy in ("ring", "ulysses")}


def _sp(inp, rank, world):
    groups = _pp_groups()
    wg = torch.distributed.group.WORLD
    return {"attn": _sp_attention(inp, rank, wg),
            "dropout": _sp_dropout(inp, rank, wg),
            "models": _sp_models(inp, rank, wg),
            "block3d": _sp_3d(inp, rank, groups),
            "example": _sp_example(inp)}


# -- suite "dcp" ----------------------------------------------------------------

def _dcp_pair():
    gen = torch.Generator().manual_seed(5)
    model = torch.nn.Sequential(nn.Linear(5, 3, device="cpu", generator=gen),
                                nn.Linear(3, 2, device="cpu", generator=gen))
    return amp.initialize(model, optimizers.FusedAdam(lr=1e-2),
                          opt_level="O2", verbosity=0)


def _dcp_whole(opt):
    """The ZeRO windows of the masters and the moments gathered whole."""
    z, total = opt._zero, opt.masters.layout.total
    out = {}
    st = opt.state_dict()
    for name, t in (("masters", st["masters"]), ("m", st["inner"]["m"]),
                    ("v", st["inner"]["v"])):
        whole = t.new_empty(z.padded)
        torch.distributed.all_gather_into_tensor(whole, t.contiguous(),
                                                 group=z.group)
        out[name] = _np(whole[:total])
    out["step"] = int(st["inner"]["step"])
    out["loss_scale"] = float(st["scalers"][0]["loss_scale"])
    return out


def _dcp(inp, rank, world):
    """ZeRO-1 state over the world (windows of ceil(26 / 4) = 7, the last
    padded by 2) saved through checkpoint_orbax as DTensors, sync and
    async; read back into a ZeRO-2 layout (two windows of 13 over a
    (2, 2) mesh, replicated across its rows) and a torn save refused."""
    from apex_tpu_torch.utils import checkpoint_orbax as co
    ck = inp["dir"]
    model, opt = _dcp_pair()
    opt.zero_shard()
    x = torch.from_numpy(_half(inp["x"], rank, world))
    for _ in range(2):
        loss, grads = amp.scaled_grad(lambda: (model(x) ** 2).mean(), opt)
        opt.step(grads)
    out = {"saved": _dcp_whole(opt), "window": opt._zero.shard_n}
    co.save_checkpoint(ck, 1, co.zero_state(opt))
    co.save_checkpoint(ck, 2, co.zero_state(opt), async_save=True,
                       data_state={"cursor": 3})
    co.wait()
    model2, opt2 = _dcp_pair()
    opt2.zero_shard(zero_stage=2, zero_ici_size=2)
    out["before"] = _dcp_whole(opt2)
    co.restore_checkpoint(ck, co.zero_state(opt2), step=1)
    opt2.load_state_dict(opt2.state_dict())     # gathers the parameters
    out["resharded"] = _dcp_whole(opt2)
    out["params"] = {n: _np(p) for n, p in model.named_parameters()}
    out["params2"] = {n: _np(p) for n, p in model2.named_parameters()}
    out["data_state"] = co.load_data_state(ck, step=2)
    return out


# -- suite "numerics" ---------------------------------------------------------

def _flushed_numpy(nm, tele):
    from apex_tpu_torch.observability import MetricsRegistry
    return nm.flush(tele, registry=MetricsRegistry())


def _numerics_digest(inp, rank, group):
    """The divergence digest on the 2-rank group: a clean run, a step
    where rank 1 drifts by 1e-3 on layer1, a re-synced step, and a
    nonfinite replica."""
    from apex_tpu_torch.observability import EventRing
    from apex_tpu_torch.observability import numerics as N
    params = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    ring = EventRing()
    nm = N.NumericsMonitor(params, digest=True, axis_name=group,
                           ring=ring, device="cpu")
    tele = nm.init()
    out = {}

    def step(poison):
        bump = 1e-3 if (poison and rank == 1) else 0.0
        p = {**params, "layer1": params["layer1"] + bump}
        nm.update(tele, sync_tree=p)

    for _ in range(6):
        step(False)
    out["clean"] = _flushed_numpy(nm, tele)
    step(True)
    out["poisoned"] = _flushed_numpy(nm, tele)
    step(False)
    out["resynced"] = _flushed_numpy(nm, tele)
    out["ring"] = [ev["kind"] for ev in ring.snapshot()]
    nan_t = {"w": torch.ones(8) + (float("nan") if rank == 0 else 0.0)}
    out["nonfinite"] = float(N.divergence_check(nan_t, group)["max_rel_dev"])
    return out


def _numerics_buckets(inp, rank, **kw):
    """``numerics_out`` of one DDP reduction of this rank's grads."""
    grads = [torch.from_numpy(g).to(DTYPES[dt]) * (rank + 1)
             for g, dt in zip(inp["bucket_grads"], inp["bucket_dtypes"])]
    model = _Holder({f"p{i}": (g.shape, dt) for i, (g, dt) in
                     enumerate(zip(inp["bucket_grads"],
                                   inp["bucket_dtypes"]))})
    ddp = parallel.DistributedDataParallel(model, **kw)
    nout = []
    red = ddp.allreduce_grads(grads, numerics_out=nout)
    return {"stats": [{k: (float(v) if isinstance(v, torch.Tensor) else v)
                       for k, v in b.items()} for b in nout],
            "reduced": [_np(t) for t in red],
            "comm": ddp.last_comm_stats}


def _numerics_hier(inp, rank):
    """The 2 x 2 hierarchical reduce with the bf16 cross-node hop: each
    rank's compression error, and ``record_numerics`` of a flushed
    monitor."""
    from apex_tpu_torch.observability import numerics as N
    g = torch.from_numpy(inp["hier_g"]) + rank
    model = _Holder({"w": (g.shape, "float32")})
    ddp = parallel.DistributedDataParallel(
        model, comm_topology="hierarchical", ici_size=2,
        allreduce_compress_bf16=True)
    labels = N.bucket_labels(parallel.allreduce_comm_plan(
        [g], comm_topology="hierarchical", allreduce_compress_bf16=True,
        ici_size=2, world=4))
    nm = N.NumericsMonitor(names=labels, bucket_labels=labels,
                           device="cpu")
    tele = nm.init()
    out = {}
    for name, grad in (("ones", torch.ones_like(g)), ("generic", g)):
        nout = []
        red = ddp.allreduce_grads([grad], numerics_out=nout)
        nm.update(tele, bucket_stats=nout)
        out[name] = {"err": float(nout[0]["compression_sq_error"]),
                     "reduced": _np(red[0])}
    fl = _flushed_numpy(nm, tele)
    out["flushed"] = fl
    out["recorded"] = ddp.record_numerics(fl) == ddp.last_numerics
    out["signals"] = ddp.supervisor_signals()
    return out


def _numerics_staged(inp, rank):
    """``numerics_out`` of the staged schedule: each stage's buckets,
    stamped with their stage and issue order."""
    ps = [{k: torch.from_numpy(v).requires_grad_() for k, v in st.items()}
          for st in inp["staged_params"]]
    model = torch.nn.Module()
    for i, st in enumerate(ps):
        for k, v in st.items():
            model.register_parameter(f"s{i}_{k}", torch.nn.Parameter(v))
    ddp = parallel.DistributedDataParallel(model)
    x = torch.from_numpy(inp["staged_x"]) * (rank + 1)

    def stage(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    nout = []
    _, grads = ddp.staged_allreduce_grads(
        [stage] * len(ps), lambda a: (a * a).sum(), ps, x,
        numerics_out=nout)
    return {"stats": [{k: (float(v) if isinstance(v, torch.Tensor) else v)
                       for k, v in b.items()} for b in nout],
            "labels": [(b["stage"], b["issue_order"])
                       for b in ddp.last_comm_stats]}


def _numerics(inp, rank, world):
    pair = torch.distributed.new_group([0, 1])
    out = {}
    if rank < 2:
        out["digest"] = _numerics_digest(inp, rank, pair)
    out["flat"] = _numerics_buckets(inp, rank)
    out["chunked"] = _numerics_buckets(inp, rank, message_size=64)
    out["fp32"] = _numerics_buckets(inp, rank, allreduce_always_fp32=True)
    out["hier"] = _numerics_hier(inp, rank)
    out["staged"] = _numerics_staged(inp, rank)
    return out


# -- suite "elastic" ----------------------------------------------------------

_ELASTIC_GROUPS = {}


def _world_group(world):
    """The group of the first ``world`` ranks, made once.  The suite makes
    every one it uses while all ranks are there (``new_group`` wants every
    rank of the default group)."""
    if world == torch.distributed.get_world_size():
        return torch.distributed.group.WORLD
    if world not in _ELASTIC_GROUPS:
        _ELASTIC_GROUPS[world] = torch.distributed.new_group(
            list(range(world)))
    return _ELASTIC_GROUPS[world]


def _mlp_model(params):
    """tests/test_recovery.py's MLP (Flatten, Linear, ReLU, Linear), its
    parameters named as the JAX tree's leaves."""
    (d_hid, d_in), (d_out, _) = (params[k]["weight"].shape
                                 for k in ("1", "3"))
    net = torch.nn.Sequential(torch.nn.Flatten(),
                              torch.nn.Linear(d_in, d_hid), torch.nn.ReLU(),
                              torch.nn.Linear(d_hid, d_out))
    with torch.no_grad():
        for k in ("1", "3"):
            for f in ("weight", "bias"):
                getattr(net[int(k)], f).copy_(torch.from_numpy(params[k][f]))
    return net


def _ddp_build_step(model, rank, lr=0.05, ddp_kw=None):
    """``build_step(world)`` over the first ``world`` ranks: each rank
    takes its slice of the global batch, the grads are averaged by DDP,
    SGD, the loss averaged over the group; ``nan_steps`` counts the
    nonfinite losses the state trained through (tests/test_recovery.py's
    probe).  ``ddp_kw(world)`` gives the wrapper's other knobs."""
    def build_step(world):
        group = _world_group(world)
        if rank >= world:
            return None
        ddp = parallel.DistributedDataParallel(
            model, process_group=group,
            **(ddp_kw(world) if ddp_kw is not None else {}))
        by_name = dict(model.named_parameters())
        params = [by_name[n] for n in ddp._names]

        def step(state, batch):
            _, nan_steps = state
            xb, yb = (torch.as_tensor(np.asarray(b)) for b in batch)
            n = xb.shape[0] // world
            xs = xb[rank * n:(rank + 1) * n].float()
            ys = yb[rank * n:(rank + 1) * n].long()
            loss = cross_entropy(model(xs), ys)
            grads = torch.autograd.grad(loss, params)
            red = ddp.allreduce_grads(list(grads))
            with torch.no_grad():
                for p, g in zip(params, red):
                    p.copy_(p - lr * g)
            avg = loss.detach().clone()
            torch.distributed.all_reduce(avg, group=group)
            avg = avg / world
            nan_steps.add_((~torch.isfinite(avg)).to(nan_steps.dtype))
            return state, avg
        return step
    return build_step


def _mlp_io(model):
    """(to_host, from_host) of the (model, nan_steps) state: the params
    by their JAX paths, written back in place."""
    def to_host(state):
        m, nan_steps = state
        return {"params": {n: _np(p) for n, p in m.named_parameters()},
                "nan_steps": nan_steps.numpy().copy()}

    def from_host(tree, world):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(np.asarray(tree["params"][n])))
        nan_steps.copy_(torch.from_numpy(np.asarray(tree["nan_steps"])))
        return (model, nan_steps)

    nan_steps = torch.zeros((), dtype=torch.int32)
    return (model, nan_steps), to_host, from_host


def _trainer_out(tr, ring=None):
    rec = tr.record()
    return {"history": [(int(s), float(l), int(w)) for s, l, w in
                        tr.history],
            "world": tr.world, "recoveries": tr.recoveries,
            "resumed_step": tr.resumed_step, "verdict": tr.verdict,
            "cause": tr.cause, "record": rec,
            "ring": [] if ring is None else
            [{k: v for k, v in e.items() if k not in ("seq", "t")}
             for e in ring.snapshot()]}


def _elastic_mlp(inp, rank, ck, scenario):
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.fleet import (ElasticConfig, ElasticTrainer,
                                      TrainingFaults)
    clock = lambda: 0.0  # noqa: E731
    model = _mlp_model(inp["mlp"])
    state, to_host, from_host = _mlp_io(model)
    ring = obs.EventRing(256, clock=clock)
    sup = obs.RunSupervisor(scenario, ring=ring, clock=clock,
                            registry=obs.MetricsRegistry())
    batches = inp["batches"]
    poisoned = {"done": False}

    def data_fn(i):
        x, y = batches[i]
        if scenario == "nan" and i == 6 and not poisoned["done"]:
            poisoned["done"] = True
            x = x.copy()
            x[0, 0] = np.nan
        return x, y

    faults = {"death": dict(replica_death=(5, 6)),
              "double": dict(replica_death=((5, 6), (9, 10))),
              "torn": dict(replica_death=(5, 6), torn_checkpoint=(4, 5)),
              "nan": {}}[scenario]
    faults = TrainingFaults(seed=0, ring=ring, **faults) if faults else None
    prev = obs.set_ring(ring)
    try:
        tr = ElasticTrainer(
            _ddp_build_step(model, rank), state, world=4, ckpt_dir=ck,
            to_host=to_host, from_host=from_host, supervisor=sup,
            faults=faults, config=ElasticConfig(checkpoint_every=2,
                                                min_world=1),
            ring=ring, registry=obs.MetricsRegistry(), run=scenario,
            clock=clock)
        tr.run({"torn": 8}.get(scenario, 10), data_fn)
    finally:
        obs.set_ring(prev)
    out = _trainer_out(tr, ring)
    out["nan_steps"] = int(state[1])
    out["sup"] = {"health": sup.health_check(),
                  "recoveries": sup.status()["recoveries"],
                  "nan": sup.status()["anomaly_counts"]["nan"]}
    if faults is not None:
        out["torn_paths"] = [os.path.basename(p) for p in faults.torn_paths]
    if scenario == "death" and rank < 2:
        # the undisturbed shrunk-world run from the same snapshot
        from apex_tpu_torch.utils import checkpoint as ckpt
        st, _, fh = _mlp_io(model)
        fh(ckpt.restore_checkpoint(ck, to_host(st), step=4), 2)
        step2 = _ddp_build_step(model, rank)(2)
        out["undisturbed"] = [float(step2(st, batches[i])[1])
                              for i in range(4, 10)]
    return out


def _zero_pair(inp, world, rank):
    """tests/test_recovery.py's ZeRO-1 net (Flatten, Linear(24, 10)) under
    O2 + FusedAdam, sharded over the first ``world`` ranks."""
    from apex_tpu_torch import amp as pamp
    net = torch.nn.Sequential(torch.nn.Flatten(),
                              torch.nn.Linear(24, 10))
    with torch.no_grad():
        net[1].weight.copy_(torch.from_numpy(inp["zero_w"]))
        net[1].bias.copy_(torch.from_numpy(inp["zero_b"]))
    model, opt = pamp.initialize(net, optimizers.FusedAdam(lr=1e-2),
                                 opt_level="O2", verbosity=0)
    opt.zero_shard(zero_stage=1, process_group=_world_group(world))
    return model, opt


def _zero_io(total):
    from apex_tpu_torch.fleet import reshard_flat_state

    def to_host(state):
        model, opt, world = state
        z = opt._zero
        sd = opt.state_dict()
        flat = {"masters": sd["masters"], **{
            k: v for k, v in sd["inner"].items()
            if isinstance(v, torch.Tensor) and v.dim() == 1
            and v.shape[0] == z.shard_n}}
        whole = {}
        for k, v in flat.items():
            out = v.new_empty(z.padded)
            torch.distributed.all_gather_into_tensor(out, v.contiguous(),
                                                     group=z.group)
            whole[k] = out.numpy().copy()
        rest = {k: (v.numpy().copy() if isinstance(v, torch.Tensor)
                    else np.asarray(v))
                for k, v in sd["inner"].items() if k not in flat}
        return {"flat": reshard_flat_state(whole, total, z.shards, 1),
                "rest": rest,
                "scalers": [{k: np.asarray(v.numpy()) for k, v in s.items()}
                            for s in sd["scalers"]]}

    return to_host


def _elastic_zero(inp, rank, ck):
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.fleet import (ElasticConfig, ElasticTrainer,
                                      TrainingFaults, reshard_flat_state)
    from apex_tpu_torch.utils import checkpoint as ckpt
    live = {4: _zero_pair(inp, 4, rank)}
    total = live[4][1].masters.layout.total
    to_host = _zero_io(total)

    def from_host(tree, world):
        model, opt = live[world]
        z = opt._zero
        padded = reshard_flat_state(tree["flat"], total, 1, world)
        win = {k: torch.from_numpy(np.asarray(v)[z.index * z.shard_n:
                                                  (z.index + 1) * z.shard_n]
                                   .copy())
               for k, v in padded.items()}
        inner = {k: torch.from_numpy(np.array(v))
                 for k, v in tree["rest"].items()}
        inner.update({k: v for k, v in win.items() if k != "masters"})
        opt.load_state_dict({"masters": win["masters"], "inner": inner,
                             "scalers": [{k: torch.from_numpy(np.array(v))
                                          for k, v in s.items()}
                                         for s in tree["scalers"]]})
        return (model, opt, world)

    def build_step(world):
        group = _world_group(world)
        if rank >= world:
            return None
        if world not in live:
            live[world] = _zero_pair(inp, world, rank)

        def step(state, batch):
            model, opt, _ = state
            xb, yb = (torch.from_numpy(np.asarray(b)) for b in batch)
            n = xb.shape[0] // world
            xs, ys = xb[rank * n:(rank + 1) * n], yb[rank * n:(rank + 1) * n]
            loss, grads = amp.scaled_grad(
                lambda x, y: cross_entropy(model(x).float(), y.long()),
                opt, xs, ys)
            opt.step(grads)
            avg = loss.detach().float().clone()
            torch.distributed.all_reduce(avg, group=group)
            return state, avg / world
        return step

    faults = TrainingFaults(replica_death=(3, 4), seed=0)
    tr = ElasticTrainer(build_step, (*live[4], 4), world=4, ckpt_dir=ck,
                        to_host=to_host, from_host=from_host, faults=faults,
                        config=ElasticConfig(checkpoint_every=1,
                                             min_world=1),
                        registry=obs.MetricsRegistry(), run="zero_elastic",
                        clock=lambda: 0.0)
    tr.run(7, lambda i: inp["batches"][i])
    out = _trainer_out(tr)
    if rank < 2:
        opt = tr._state[1]
        out["buf"] = int(opt.masters.buf.shape[0])
        out["padded"] = int(opt._zero.padded)
        out["total"] = total
        # the undisturbed world-2 run from the same snapshot
        template = to_host(tr._state)
        live[2] = _zero_pair(inp, 2, rank)
        st = from_host(ckpt.restore_checkpoint(ck, template, step=3), 2)
        step2 = build_step(2)
        out["undisturbed"] = [float(step2(st, inp["batches"][i])[1])
                              for i in range(3, 7)]
    return out


def _elastic_preempt(inp, rank, ck):
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.data import DataLoader
    from apex_tpu_torch.fleet import (ElasticConfig, ElasticTrainer,
                                      PreemptionGuard, TrainingFaults)
    clock = lambda: 0.0  # noqa: E731
    images, labels = inp["images"], inp["labels"]

    def run_trainer(d, log, **kw):
        model = _mlp_model(inp["mlp48"])
        state, to_host, from_host = _mlp_io(model)
        loader = DataLoader(images, labels, batch_size=16, shuffle=True,
                            seed=7, native=False)

        def data_fn(i):
            imgs, lbls, _ = loader.next_batch()
            log.append(tuple(int(v) for v in lbls))
            return imgs, lbls
        tr = ElasticTrainer(
            _ddp_build_step(model, rank), state, world=4,
            ckpt_dir=os.path.join(ck, d), to_host=to_host,
            from_host=from_host, data=loader,
            config=ElasticConfig(checkpoint_every=3, min_world=1),
            registry=obs.MetricsRegistry(), clock=clock, **kw)
        tr.run(10, data_fn)
        return tr

    und_log, pre_log = [], []
    und = run_trainer("und", und_log, run="preempt_und")
    ring = obs.EventRing(256, clock=clock)
    sup = obs.RunSupervisor("preempt_test", ring=ring, clock=clock,
                            registry=obs.MetricsRegistry())
    guard = PreemptionGuard(grace_s=60.0, ring=ring, clock=clock,
                            registry=obs.MetricsRegistry())
    faults = TrainingFaults(preemption=(4, 5), seed=0, ring=ring)
    pre = run_trainer("pre", pre_log, guard=guard, faults=faults,
                      supervisor=sup, ring=ring, run="preempt_run")
    pre_out = _trainer_out(pre, ring)
    pre_out["sup"] = {"preempted": sup.preempted,
                      "health": sup.health_check(),
                      "preempted_step": sup.status()["preempted_step"]}
    res = run_trainer("pre", pre_log, resume=True, run="preempt_resumed")
    return {"und": _trainer_out(und), "pre": pre_out,
            "res": {**_trainer_out(res),
                    "overhead": res.resume_overhead_s},
            "und_log": und_log, "pre_log": pre_log,
            "guard_wired": faults.guard is guard}


def _elastic(inp, rank, world):
    root = inp["ckpt_root"]
    for w in (2, 1):
        _world_group(w)
    out = {}
    for scenario in ("death", "double", "torn", "nan"):
        out[scenario] = _elastic_mlp(inp, rank, os.path.join(root, scenario),
                                     scenario)
        torch.distributed.barrier()
    out["zero"] = _elastic_zero(inp, rank, os.path.join(root, "zero"))
    torch.distributed.barrier()
    out["preempt"] = _elastic_preempt(inp, rank,
                                      os.path.join(root, "preempt"))
    return out


# -- suite "elastic_hier" -----------------------------------------------------

def _ici_of(world):
    """tests/test_recovery.py's node width: half the world."""
    return max(world // 2, 1)


def _hier_groups(worlds):
    """Every group the 8 -> 4 runs use, made while all ranks are there: the
    first ``w`` ranks and their node groups, for each world ``w``."""
    from apex_tpu_torch.parallel import topology
    for w in worlds:
        _world_group(w)
        topology.hierarchical_groups(_ici_of(w), w, range(w))


def _zero_hier_pair(inp, world, stage):
    """tests/test_recovery.py's ZeRO net (Flatten, Linear(24, 10)) under O2
    + FusedAdam, sharded at ``stage`` over the node groups of the first
    ``world`` ranks."""
    from apex_tpu_torch import amp as pamp
    net = torch.nn.Sequential(torch.nn.Flatten(),
                              torch.nn.Linear(24, 10))
    with torch.no_grad():
        net[1].weight.copy_(torch.from_numpy(inp["zero_w"]))
        net[1].bias.copy_(torch.from_numpy(inp["zero_b"]))
    model, opt = pamp.initialize(net, optimizers.FusedAdam(lr=1e-2),
                                 opt_level="O2", verbosity=0)
    opt.zero_shard(zero_stage=stage, zero_ici_size=_ici_of(world),
                   process_group=_world_group(world))
    return model, opt


def _elastic_zero_hier(inp, rank, ck, stage):
    """ZeRO-2 (a death at observed step 3, a snapshot a step) or ZeRO-3 (a
    torn step-4 snapshot, then a death at observed step 5, a snapshot
    every two steps) under an 8 -> 4 shrink, the node 4 -> 2."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.fleet import (ElasticConfig, ElasticTrainer,
                                      TrainingFaults, reshard_flat_state)
    from apex_tpu_torch.utils import checkpoint as ckpt
    live = {8: _zero_hier_pair(inp, 8, stage)}
    total = live[8][1].masters.layout.total
    to_host = _zero_io(total)

    def from_host(tree, world):
        model, opt = live[world]
        z = opt._zero
        padded = reshard_flat_state(tree["flat"], total, 1, z.shards)
        win = {k: torch.from_numpy(np.asarray(v)[z.index * z.shard_n:
                                                  (z.index + 1) * z.shard_n]
                                   .copy())
               for k, v in padded.items()}
        inner = {k: torch.from_numpy(np.array(v))
                 for k, v in tree["rest"].items()}
        inner.update({k: v for k, v in win.items() if k != "masters"})
        opt.load_state_dict({"masters": win["masters"], "inner": inner,
                             "scalers": [{k: torch.from_numpy(np.array(v))
                                          for k, v in s.items()}
                                         for s in tree["scalers"]]})
        return (model, opt, world)

    def build_step(world):
        group = _world_group(world)
        if rank >= world:
            return None
        if world not in live:
            live[world] = _zero_hier_pair(inp, world, stage)

        def step(state, batch):
            model, opt, _ = state
            xb, yb = (torch.from_numpy(np.asarray(b)) for b in batch)
            n = xb.shape[0] // world
            xs, ys = xb[rank * n:(rank + 1) * n], yb[rank * n:(rank + 1) * n]
            if stage == 3:
                # the just-in-time gather: the model holds no parameters
                def loss_fn(x, y):
                    out = torch.func.functional_call(
                        model, amp.zero_gather_params(opt), (x,))
                    return cross_entropy(out.float(), y.long())
            else:
                def loss_fn(x, y):
                    return cross_entropy(model(x).float(), y.long())
            loss, grads = amp.scaled_grad(loss_fn, opt, xs, ys)
            opt.step(grads)
            avg = loss.detach().float().clone()
            torch.distributed.all_reduce(avg, group=group)
            return state, avg / world
        return step

    if stage == 2:
        faults, every, steps, resume = dict(replica_death=(3, 4)), 1, 7, 3
    else:
        faults, every, steps, resume = (dict(replica_death=(5, 6),
                                             torn_checkpoint=(4, 5)),
                                        2, 8, 2)
    ring = obs.EventRing(256, clock=lambda: 0.0)
    tr = ElasticTrainer(build_step, (*live[8], 8), world=8, ckpt_dir=ck,
                        to_host=to_host, from_host=from_host,
                        faults=TrainingFaults(seed=0, ring=ring, **faults),
                        config=ElasticConfig(checkpoint_every=every,
                                             min_world=2),
                        ring=ring, registry=obs.MetricsRegistry(),
                        run=f"zero{stage}_elastic", clock=lambda: 0.0)
    tr.run(steps, lambda i: inp["batches"][i])
    out = _trainer_out(tr, ring)
    if rank < 4:
        opt = tr._state[1]
        z = opt._zero
        out.update(buf=int(opt.masters.buf.shape[0]), padded=int(z.padded),
                   total=total, shards=z.shards, ici=z.ici,
                   group_ranks=torch.distributed.get_process_group_ranks(
                       z.group))
        # the undisturbed world-4 run from the same snapshot
        template = to_host(tr._state)
        live[4] = _zero_hier_pair(inp, 4, stage)
        st = from_host(ckpt.restore_checkpoint(ck, template, step=resume),
                       4)
        step4 = build_step(4)
        out["undisturbed"] = [float(step4(st, inp["batches"][i])[1])
                              for i in range(resume, steps)]
    return out


def _elastic_loader_hier(inp, rank, ck):
    """tests/test_recovery.py:684's replica death with a ``DataLoader``
    across an 8 -> 4 shrink, each rank a trainer over hierarchical DDP (the
    node 4 -> 2 with the world); rank 0's cursor goes in the snapshot."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.data import DataLoader
    from apex_tpu_torch.fleet import (ElasticConfig, ElasticTrainer,
                                      TrainingFaults)
    from apex_tpu_torch.utils import checkpoint as ckpt
    model = _mlp_model(inp["mlp48"])
    state, to_host, from_host = _mlp_io(model)
    hier = dict(comm_topology="hierarchical")
    build = _ddp_build_step(model, rank,
                            ddp_kw=lambda w: {**hier, "ici_size": _ici_of(w)})

    def loader():
        return DataLoader(inp["images"], inp["labels"], batch_size=16,
                          shuffle=True, seed=7, native=False)
    data = loader()
    log = []
    draw = data.next_batch

    def logged():
        b = draw()
        log.append([int(v) for v in b[1]])
        return b
    data.next_batch = logged
    tr = ElasticTrainer(build, state, world=8, ckpt_dir=ck,
                        to_host=to_host, from_host=from_host, data=data,
                        faults=TrainingFaults(replica_death=(5, 6), seed=0),
                        config=ElasticConfig(checkpoint_every=2,
                                             min_world=1),
                        registry=obs.MetricsRegistry(), run="death_loader",
                        clock=lambda: 0.0)
    tr.run(10)
    out = _trainer_out(tr)
    out["consumed"] = int(data.stats()["samples_consumed"])
    out["log"] = log
    if rank < 4:
        ds = ckpt.load_data_state(ck, step=4)
        out["ds_consumed"] = int(ds["samples_consumed"])
        st, _, fh = _mlp_io(model)
        fh(ckpt.restore_checkpoint(ck, to_host(st), step=4), 4)
        fresh = loader()
        fresh.load_state_dict(ds)
        step4 = build(4)
        und = []
        for _ in range(4, 10):
            imgs, lbls, _ = fresh.next_batch()
            und.append(float(step4(st, (imgs, lbls))[1]))
        out["undisturbed"] = und
    return out


def _subgroup_hier(inp, rank):
    """Hierarchical DDP and hierarchical Adasum over the shrunk world's
    group (the first 4 of 8 ranks, nodes of 2), beside flat DDP over it."""
    from apex_tpu_torch.parallel import adasum_grads
    if rank >= 4:
        return {}
    g4 = _world_group(4)
    g = inp["g1001"]
    out = {"flat": _reduce_with(_rank_grads(g, rank), process_group=g4)[0]}
    red, _, stats = _reduce_with(_rank_grads(g, rank), process_group=g4,
                                 comm_topology="hierarchical", ici_size=2)
    out["hier"], out["hier_stats"] = red, stats
    sl = torch.from_numpy(inp["ada_slices"][rank // 2])
    out["adasum_hier"] = _np(adasum_grads([sl], g4, ici_size=2)[0])
    out["adasum_flat"] = _np(adasum_grads([sl], g4)[0])
    return out


def _elastic_hier(inp, rank, world):
    root = inp["ckpt_root"]
    _hier_groups((8, 4, 2, 1))
    out = {"subgroup": _subgroup_hier(inp, rank)}
    torch.distributed.barrier()
    for stage in (2, 3):
        out[f"zero{stage}"] = _elastic_zero_hier(
            inp, rank, os.path.join(root, f"zero{stage}"), stage)
        torch.distributed.barrier()
    out["loader"] = _elastic_loader_hier(inp, rank,
                                         os.path.join(root, "loader"))
    return out


# -- suite "analysis" ---------------------------------------------------------

def _analysis_mutants(inp, rank, world):
    """Steps seeded with what the analysis rules must flag, and their
    honest twins, traced on 8 ranks (each rank 0's trace comes back)."""
    from apex_tpu_torch.analysis import entry_points as E
    from apex_tpu_torch.parallel import topology
    dist = torch.distributed
    ici_g, dcn_g = topology.hierarchical_groups(4, world)
    n = 1024
    out = {}

    def traced(name, step, *args, state=None, sharded=(), **kw):
        g = E.trace_ranked(step, *args, group=None,
                           mesh_axes={"data": world}, sharded=sharded,
                           state=state or (lambda: {}), **kw)
        if rank == 0:
            out[name] = g.trace

    # collective counts and payloads: one or two all-reduces, a smuggled
    # all-gather, and a step with no matmul
    x8 = torch.ones(4, 8)

    def psums(k):
        def step():
            y = x8.clone()
            for _ in range(k):
                dist.all_reduce(y)
            return y
        return step
    traced("psum1", psums(1))
    traced("psum2", psums(2))

    def gather():
        o = torch.empty(world * 4, 8)
        dist.all_gather_into_tensor(o, x8.clone())
        return o
    traced("all_gather", gather)

    # the hierarchical reduce of one flat tensor, honest and with the
    # full-size cross-node all-reduce / a smuggled world all-gather /
    # the flat all-reduce under hierarchical expectations
    holder = _holder([(n,)])
    hier = parallel.DistributedDataParallel(
        holder, comm_topology="hierarchical", ici_size=4,
        gradient_average=False)
    w = torch.arange(n, dtype=torch.float32) * (rank + 1)

    def honest():
        return hier.allreduce_grads([w])[0]

    def sneaky():
        shard = torch.empty(n // 4)
        dist.reduce_scatter_tensor(shard, w.clone(), group=ici_g)
        full = torch.empty(n)
        dist.all_gather_into_tensor(full, shard, group=ici_g)
        dist.all_reduce(full, group=dcn_g)      # n elements cross-node
        return full

    def gathered():
        y = honest()
        g = torch.empty(world * n)
        dist.all_gather_into_tensor(g, y)
        return y + g[:n]

    def flat():
        y = w.clone()
        dist.all_reduce(y)
        return y
    for name, fn in (("hier_honest", honest), ("hier_fat_dcn", sneaky),
                     ("hier_gathered", gathered), ("flat", flat)):
        traced(name, fn)

    # the overlapped staged steps against their reduce-after-backward
    # twins (the same census, only the positions differ)
    for name, kw in (("overlap_hier_off", dict(overlap=False)),
                     ("zero2_overlap_off", dict(overlap=False,
                                                zero2=True))):
        ep = E.EntryPoint(name, lambda ep, kw=kw: E._staged_mlp_graph(
            ep, **kw))
        gr = ep.graph()
        if rank == 0:
            out[name] = gr.trace

    # sharding: a state leaf written with rank-local values under a
    # replicated claim, then re-synced; a replicated and a sharded leaf
    # of 4 KB for the ledger
    leaf = torch.ones(n)

    def diverge():
        leaf.mul_(float(rank + 1))

    def resync():
        dist.all_reduce(leaf)
    traced("divergent", diverge, state=lambda: {"state": {"leaf": leaf}})
    traced("synced", resync, state=lambda: {"state": {"leaf": leaf}})
    rep = torch.ones(n)
    traced("replicated_leaf", lambda: dist.all_reduce(rep.clone()),
           state=lambda: {"state": {"leaf": rep}})
    traced("sharded_leaf", lambda: dist.all_reduce(rep.clone()),
           state=lambda: {"state": {"leaf": rep}},
           sharded=("state.leaf",))

    # numerics and the supervisor: a base step (a matmul, its grad
    # all-reduced), an instrumented twin with the digest's one extra
    # all-reduce, one that also reads a value back, one with a second
    # extra all-reduce, and a "disabled" twin with residue
    wt = torch.ones(8, 8, requires_grad=True)

    def base_step(extra=0, sync=False, residue=False):
        def step():
            y = (x8 @ wt).tanh().sum()
            (gw,) = torch.autograd.grad(y, [wt])
            dist.all_reduce(gw)
            if residue:
                gw = gw * 1.0
            for _ in range(extra):
                d = gw.sum().reshape(1)
                dist.all_reduce(d)
                if sync:
                    float(d)
            return gw
        return step
    traced("num_base", base_step())
    traced("num_on", base_step(extra=1))
    traced("num_sync", base_step(extra=1, sync=True))
    traced("num_extra", base_step(extra=2))
    traced("num_residue", base_step(residue=True))
    return out


def _analysis(inp, rank, world):
    from apex_tpu_torch.analysis import entry_points as E
    out = {"entries": E.rank_job(inp["names"])}
    if inp.get("mutants"):
        out["mutants"] = _analysis_mutants(inp, rank, world)
    return out


# -- suite "steptime" ---------------------------------------------------------

def _steptime(inp, rank, world):
    """``attribute_step`` over a DDP step, its ``comm_enabled=False`` twin
    and the isolated all-reduce; the twin's collectives counted."""
    from apex_tpu_torch.observability import steptime
    model = _mlp_model(inp["mlp"])
    ddp = parallel.DistributedDataParallel(model)
    by_name = dict(model.named_parameters())
    params = [by_name[n] for n in ddp._names]
    x = torch.from_numpy(inp["x"][rank])
    y = torch.from_numpy(inp["y"][rank]).long()
    counter = _CountingAllReduce()
    torch.distributed.all_reduce = counter

    def make(comm):
        def step():
            ddp.comm_enabled = comm
            loss = cross_entropy(model(x), y)
            grads = torch.autograd.grad(loss, params)
            red = ddp.allreduce_grads(list(grads))
            ddp.comm_enabled = True
            return red
        return step

    bufs = [torch.zeros_like(p) for p in params]
    out = {}
    try:
        counter.calls = 0
        twin = make(False)()
        out["twin_calls"] = counter.calls
        out["twin_stats"] = list(ddp.last_comm_stats)
        counter.calls = 0
        full = make(True)()
        out["full_calls"] = counter.calls
        loss = cross_entropy(model(x), y)
        local = torch.autograd.grad(loss, params)
        out["twin_is_local_mean"] = all(
            torch.equal(t, g / torch.full((), float(world)))
            for t, g in zip(twin, local))
        out["full"] = [_np(t) for t in full]
        counter.calls = 0
        out["att"] = steptime.attribute_step(
            make(True), make(False), lambda: ddp.allreduce_grads(bufs),
            plan=parallel.allreduce_comm_plan(dict(zip(ddp._names,
                                                       params))),
            iters=3, warmup=1, schedule=None)
        out["att_calls"] = counter.calls
        # the measured split: the full step's top-level operators,
        # captured under torch.profiler on this rank's thread
        timed = steptime.attribute_step(
            make(True), make(False), lambda: ddp.allreduce_grads(bufs),
            iters=2, warmup=1, capture_timeline=True, capture_iters=2)
        out["timeline"] = {k: timed[k] for k in (
            "timeline", "measured_overlap_fraction", "consistency")}
        with _Raises(ValueError) as err:
            steptime.blocked_time(make(True), iters=0)
        out["iters_error"] = err.message
    finally:
        torch.distributed.all_reduce = counter.inner
    return out


class _Raises:
    """A context that swallows the expected exception and keeps its
    message (the worker has no pytest)."""

    def __init__(self, kind):
        self.kind = kind

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        if kind is None:
            raise AssertionError(f"{self.kind.__name__} not raised")
        self.message = str(value)
        return issubclass(kind, self.kind)


SUITES = {"syncbn": _syncbn, "ddp": _ddp, "make_step": _make_step,
          "wide_ddp": _wide_ddp, "zero": _zero, "tp": _tp, "ep": _ep,
          "pp": _pp, "sp": _sp, "dcp": _dcp, "numerics": _numerics,
          "elastic": _elastic, "elastic_hier": _elastic_hier,
          "analysis": _analysis,
          "steptime": _steptime}
WORLD = 2


def run(suite: str, inputs: dict, tmp_dir, world: int = WORLD) -> list:
    """Run SUITE on ``world`` gloo ranks through the port's launcher, with a
    ``file://`` store under ``tmp_dir``; returns each rank's results."""
    tmp_dir = os.fspath(tmp_dir)
    in_path = os.path.join(tmp_dir, f"{suite}-inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="2")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")      # the ranks share a host
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nprocs", str(world), "--init-method",
         f"file://{os.path.join(tmp_dir, suite + '-store')}",
         os.path.abspath(__file__), suite, in_path, tmp_dir],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    out = []
    for rank in range(world):
        with open(os.path.join(tmp_dir, f"{suite}-{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def main():
    suite, in_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(2)
    rank = parallel.init_process_group()
    world = torch.distributed.get_world_size()
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    out = SUITES[suite](inp, rank, world)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"{suite}-{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
