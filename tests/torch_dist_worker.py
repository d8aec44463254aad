"""Rank worker for the port's multi-process CPU tests (gloo).

Run by ``tests/test_torch_syncbn.py``, ``tests/test_torch_ddp.py`` and
``tests/test_torch_make_step_ddp.py`` through the port's launcher::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 2 \\
        --init-method file:///tmp/.../store \\
        tests/torch_dist_worker.py SUITE INPUTS.pkl OUT_DIR

Each rank reads the numpy inputs the test made, runs every scenario of
SUITE (``syncbn``, ``ddp`` or ``make_step``) on its half of the batch,
and writes its results as numpy arrays to ``OUT_DIR/SUITE-<rank>.pkl``.
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


# -- suite "syncbn" ------------------------------------------------------------

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


# -- suite "ddp" -----------------------------------------------------------------

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


# -- suite "make_step" ----------------------------------------------------------

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


def _toy_pair(inp):
    return amp.initialize(_ToyNode(inp["toy"]),
                          optimizers.FusedAdam(lr=1e-3, weight_decay=0.01),
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
                            ("z3", 3, dict(zero_ici_size=2))):
        model, opt = _toy_pair(inp)
        opt.zero_shard(zero_stage=stage, **kw)
        res = {"info": _toy_steps(model, opt, grads[:K], rank, stage)}
        res["at_k"] = _zero_state(opt)
        res["info"] += _toy_steps(model, opt, grads[K:], rank, stage)
        res["end"] = _zero_state(opt)
        res["params"] = {n: _np(p) for n, p in model.named_parameters()}
        out[name] = res
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


SUITES = {"syncbn": _syncbn, "ddp": _ddp, "make_step": _make_step,
          "wide_ddp": _wide_ddp, "zero": _zero}
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
