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


SUITES = {"syncbn": _syncbn, "ddp": _ddp, "make_step": _make_step}
WORLD = 2


def run(suite: str, inputs: dict, tmp_dir) -> list:
    """Run SUITE on WORLD gloo ranks through the port's launcher, with a
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
         "--nprocs", str(WORLD), "--init-method",
         f"file://{os.path.join(tmp_dir, suite + '-store')}",
         os.path.abspath(__file__), suite, in_path, tmp_dir],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    out = []
    for rank in range(WORLD):
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
