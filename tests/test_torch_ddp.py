"""The data-parallel slice of the port against the JAX package, on the CPU.

- ``DistributedDataParallel``'s buckets (dtype split, ``message_size``
  chunks, ``allreduce_always_fp32``, predivide, no average, trigger
  parameters, retained buffers) on 2 gloo ranks against
  ``allreduce_grads_tree`` on 2 of the JAX package's CPU devices under
  ``shard_map``, the cases of ``tests/test_ddp.py``;
- the end-of-backward all-reduce, ``flat_dist_call``, ``Reducer`` and the
  rank-0 broadcast through amp's fp32 masters;
- the slice as a whole: a [1, 1, 1, 1] Bottleneck ResNet, converted to
  SyncBatchNorm, under amp O0 + FusedAdam + DDP on 2 ranks for 3 steps,
  from the JAX package's weights, against its shard_map step;
- ``load_state_dict`` after ``amp.initialize`` (through the masters), on
  the model, on its submodules and through a one-rank DDP wrapper;
- ``init_process_group`` and the launcher.

The ranks are processes started by the port's launcher with a ``file://``
store (``tests/torch_dist_worker.py``); each gets half of a 16-sample
batch.  Inputs come from numpy seeds.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import optimizers as joptim
from apex_tpu import parallel as jparallel
from apex_tpu.nn import functional as JF

from apex_tpu_torch import amp, models, optimizers, parallel
from apex_tpu_torch.multi_tensor_apply import ChunkedFlat, ChunkedFlatLayout
from apex_tpu_torch.optimizers import LambState
from apex_tpu_torch.utils.jax_interop import lamb_state_to_jax
from apex_tpu_torch.nn.functional import cross_entropy
from apex_tpu_torch.parallel import multiproc

import torch_dist_worker

LR = 1e-5
STEPS = 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- bucket cases (tests/test_ddp.py:28-211) ------------------------------------

def _case(seed, leaves, kwargs, jax_kwargs=None, scale=1.0):
    rs = np.random.RandomState(seed)
    grads = [{k: (rs.randn(*shape) * scale).astype(np.float32)
              for k, (shape, _) in leaves.items()} for _ in range(2)]
    # bf16 leaves carry bf16 values on both sides
    for g in grads:
        for k, (_, dt) in leaves.items():
            if dt == "bfloat16":
                g[k] = np.asarray(jnp.asarray(g[k], jnp.bfloat16)
                                  .astype(jnp.float32))
    return {"grads": grads, "dtypes": {k: dt for k, (_, dt) in
                                       leaves.items()},
            "kwargs": kwargs, "jax_kwargs": jax_kwargs or kwargs}


F32, BF16 = "float32", "bfloat16"
CASES = {
    "mean": _case(0, {"w": ((5,), F32), "b": ((3,), F32)}, {}),
    "no_average": _case(1, {"w": ((4,), F32)},
                        {"gradient_average": False}),
    "predivide": _case(2, {"w": ((4,), F32)},
                       {"gradient_predivide_factor": 4.0}, scale=8.0),
    "fp32_upcast": _case(3, {"w": ((4,), BF16), "v": ((6,), BF16)},
                         {"allreduce_always_fp32": True}),
    "bf16_mean": _case(4, {"w": ((7,), BF16)}, {}),
    "chunked": _case(5, {"w": ((1000,), F32)}, {"message_size": 128}),
    "mixed": _case(6, {"a": ((4,), F32), "b": ((4,), BF16),
                       "c": ((2, 2), F32)}, {}),
    "trigger": _case(7, {"a": ((5,), F32), "b": ((3,), F32),
                         "c": ((2,), F32)},
                     {"allreduce_trigger_params": ["b"]},
                     {"trigger_paths": {"b"}}),
    # registered out of sorted order: the buckets follow JAX's leaf order
    "delay_retain": _case(8, {"c": ((3,), F32), "b": ((5,), BF16),
                              "a": ((300,), F32)},
                          {"delay_allreduce": True, "message_size": 100,
                           "retain_allreduce_buffers": True},
                          {"delay_allreduce": True, "message_size": 100}),
}


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _slice_inputs():
    jm = jparallel.convert_syncbn_model(_small_jax())
    params, state = jm.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(11)
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "state": jax.tree_util.tree_map(np.asarray, state),
            "x": rs.randn(16, 3, 32, 32).astype(np.float32),
            "y": rs.randint(0, 10, 16).astype(np.int32),
            "lr": LR, "steps": STEPS}


def _small_jax():
    return jmodels.ResNet(jmodels.resnet.Bottleneck, [1, 1, 1, 1],
                          num_classes=10)


# the tiny BERT of tests/test_torch_bert.py
BERT_CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, head_chunk=48)
LAMB_LR = 1e-3


def _bert_lamb_inputs():
    """Weights from the JAX package's init and the synthetic MLM/NSP batch
    (8 sequences of 32, the last 5 positions of two of them padding)."""
    params, _ = jmodels.BertForPretraining(
        jmodels.BertConfig(**BERT_CFG)).init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(12)
    B, T = 8, 32
    ids = rs.randint(5, BERT_CFG["vocab_size"], (B, T))
    mask = rs.rand(B, T) < 0.15
    attn = np.ones((B, T), np.int32)
    attn[[1, 6], -5:] = 0
    return {"cfg": BERT_CFG, "lr": LAMB_LR, "steps": STEPS,
            "message_size": 4096,
            "params": jax.tree_util.tree_map(np.asarray, params),
            "ids": np.where(mask & (rs.rand(B, T) < 0.8), 3, ids
                            ).astype(np.int32),
            "labels": np.where(mask, ids, -100).astype(np.int32),
            "nsp": rs.randint(0, 2, (B,)).astype(np.int32), "attn": attn}


@pytest.fixture(scope="module")
def ddp_inputs():
    rs = np.random.RandomState(10)
    return {"buckets": {k: {kk: v for kk, v in c.items()
                            if kk != "jax_kwargs"} for k, c in CASES.items()},
            "lin_x": rs.randn(16, 4).astype(np.float32),
            "lin_w": rs.randn(3, 4).astype(np.float32),
            "lin_b": rs.randn(3).astype(np.float32),
            "slice": _slice_inputs(), "bert_lamb": _bert_lamb_inputs()}


@pytest.fixture(scope="module")
def ranks(ddp_inputs, tmp_path_factory):
    return torch_dist_worker.run("ddp", ddp_inputs,
                                 tmp_path_factory.mktemp("ddp"))


def _jax_allreduce(mesh, case):
    stats, names = [], sorted(case["grads"][0])
    stacked = {k: jnp.asarray(np.stack([g[k] for g in case["grads"]]),
                              jnp.dtype(case["dtypes"][k])) for k in names}

    def fn(g):
        g = {k: v[0] for k, v in g.items()}
        retained = []
        out = jparallel.allreduce_grads_tree(
            g, "data", comm_stats=stats, retain_buffers=retained,
            **case["jax_kwargs"])
        return out, retained

    out, retained = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P("data"),), out_specs=P(),
        check_vma=False))(stacked)
    return out, retained, stats


STAT_KEYS = ("dtype", "comm_dtype", "leaves", "elements", "cause", "chunks")


# two ranks: each element is one sum of two values and one division on
# both sides, so the results are equal bit for bit
@pytest.mark.parametrize("name", sorted(CASES))
def test_ddp_buckets_match_jax_allreduce(ranks, mesh2, name):
    case = CASES[name]
    want, retained, stats = _jax_allreduce(mesh2, case)
    for r in ranks:
        got = r["buckets"][name]
        for k, v in want.items():
            assert got["grad_dtypes"][k] == str(v.dtype), k
            np.testing.assert_array_equal(got["grads"][k],
                                          np.asarray(v, np.float32), k)
        assert [{k: s[k] for k in STAT_KEYS} for s in got["stats"]] == \
            [{k: s[k] for k in STAT_KEYS} for s in stats]
        if case["kwargs"].get("retain_allreduce_buffers"):
            assert len(got["buffers"]) == len(retained)
            for a, b in zip(got["buffers"], retained):
                np.testing.assert_array_equal(a, np.asarray(b, np.float32))
        else:
            assert got["buffers"] == []


def test_ddp_reduces_at_the_end_of_backward(ranks):
    local = [r["backward"]["local"] for r in ranks]
    for r in ranks:
        for k, v in r["backward"]["reduced"].items():
            np.testing.assert_array_equal(
                v, (local[0][k] + local[1][k]) / np.float32(2), k)


def test_flat_dist_call_and_reducer(ranks):
    for r in ranks:
        c = r["collectives"]
        np.testing.assert_array_equal(c["sum"][0], [1.0, 1.0])
        np.testing.assert_array_equal(c["sum"][1], [2.0, 2.0, 2.0])
        np.testing.assert_array_equal(c["max"][0], [1.0, 1.0])
        np.testing.assert_array_equal(c["max"][1], [1.5, 1.5, 1.5])
        np.testing.assert_array_equal(c["broadcast"][0], [7.0, 7.0])
        np.testing.assert_array_equal(c["broadcast"][1], [0.5, 0.5, 0.5])
        np.testing.assert_array_equal(c["reducer"], [0.5, 0.5, 0.5])


def test_ddp_broadcast_goes_through_the_masters(ranks):
    """Rank 1 started from other weights; after DDP it holds rank 0's fp32
    masters bitwise, and a half copy derived from them."""
    r0, r1 = (r["amp_broadcast"] for r in ranks)
    assert r0["half_dtype"] == "torch.bfloat16"
    for k in ("masters", "half", "conv", "bn"):
        np.testing.assert_array_equal(r1[k], r0[k], k)
    for r in (r0, r1):
        np.testing.assert_array_equal(
            r["half"], _t(r["masters"]).to(torch.bfloat16).float().numpy())
        n_conv = r["conv"].size
        np.testing.assert_array_equal(r["conv"].ravel(), r["half"][:n_conv])
    # the BN weight is a view into the masters (leaf order: 0.weight,
    # 1.bias, 1.weight)
    np.testing.assert_array_equal(
        r0["bn"], r0["masters"][r0["conv"].size + 4:][:4])


def _paths(tree):
    return {'.'.join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _train_jax(inp, mesh):
    jm = jparallel.convert_syncbn_model(_small_jax())
    jm, jopt = jamp.initialize(jm, joptim.FusedAdam(lr=LR), opt_level="O0",
                               verbosity=0)
    ddp = jparallel.DistributedDataParallel(jm)
    params = jm.cast_params(jax.tree_util.tree_map(jnp.asarray,
                                                   inp["params"]))
    state = jax.tree_util.tree_map(jnp.asarray, inp["state"])
    ost = jopt.init(params)

    def step(st, batch):
        params, bn, ost = st
        xb, yb = batch

        def loss_fn(p):
            out, new_bn = jm.apply(p, xb, state=bn, train=True)
            return JF.cross_entropy(out, yb), new_bn

        loss, new_bn, grads = jamp.scaled_grad(loss_fn, params, ost,
                                               has_aux=True)
        grads = ddp.allreduce_grads(grads)
        params, ost, _ = jopt.step(params, ost, grads)
        return (params, new_bn, ost), lax.pmean(loss, "data")

    train = ddp.make_step(step, mesh=mesh, donate_state=False)
    st, losses, adam = (params, state, ost), [], []
    for _ in range(STEPS):
        st, loss = train(st, (jnp.asarray(inp["x"]), jnp.asarray(inp["y"])))
        losses.append(float(loss))
        adam.append({"m": np.asarray(st[2].inner.m),
                     "v": np.asarray(st[2].inner.v)})
    return losses, st, adam


# the tolerances of tests/test_torch_resnet.py at O0: fp32 on both sides,
# convolutions summed in other orders by oneDNN and XLA (losses 1e-4
# relative); FusedAdam moves a weight by about lr a step whatever its grad,
# so a near-zero grad whose sign flips costs up to 2*lr a step; running
# statistics 1e-4 in relative norm
def test_slice_resnet_syncbn_o0_ddp_two_ranks_matches_jax(ranks, ddp_inputs,
                                                          mesh2):
    inp = ddp_inputs["slice"]
    jl, (jparams, jstate, jost), jadam = _train_jax(inp, mesh2)
    tl = np.mean([r["slice"]["losses"] for r in ranks], axis=0)
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jp = _paths(jparams)
    sd0, sd1 = (r["slice"]["state_dict"] for r in ranks)
    for k in sd0:              # every rank ends with the same model
        np.testing.assert_array_equal(sd0[k], sd1[k], k)
    tm = np.concatenate([sd0[n].ravel() for n in sorted(jp)])
    jm = np.concatenate([np.asarray(jp[n]).ravel() for n in sorted(jp)])
    atol = 2 * LR * STEPS + 4 * float(np.spacing(np.abs(jm).max()))
    np.testing.assert_allclose(tm, jm, rtol=0, atol=atol)
    assert all(r["slice"]["steps"] == STEPS for r in ranks)
    assert int(jost.inner.step) == STEPS
    worst = 0.0
    for path, leaves in jstate.items():
        assert int(sd0[f"{path}.num_batches_tracked"]) == STEPS
        for k in ("running_mean", "running_var"):
            t, j = sd0[f"{path}.{k}"], np.asarray(leaves[k])
            worst = max(worst, np.linalg.norm(t - j) / np.linalg.norm(j))
    assert worst <= 1e-4, worst
    # Adam's moments on both ranks.  After step 1, m = (1-b1)*g and
    # v = (1-b2)*g^2 show the all-reduced grads themselves: held per leaf
    # against the JAX package's grads of the whole batch on one device
    # (the same math: BatchNorm over all 16 samples), in relative norm at
    # 1e-4 (measured up to 1e-5: fp32 sums in other orders).
    names, g1 = _full_batch_jax_grads(inp)
    want = {"m": 0.1 * g1, "v": 0.001 * g1 * g1}
    sizes = [g.size for g in names.values()]
    for r in ranks:
        got = r["slice"]["adam"][0]
        for k in ("m", "v"):
            off = 0
            for name, n in zip(names, sizes):
                t, j = got[k][off:off + n], want[k][off:off + n]
                off += n
                rel = np.linalg.norm(t - j) / np.linalg.norm(j)
                assert rel <= 1e-4, (k, name, rel)
    # against the shard_map step, all three steps: the JAX package's
    # two-device step itself lies up to 1.6e-3 (relative norm) from its
    # one-device grads in the stem and layer1 (ROADMAP queue 3); whole
    # vectors, measured up to 3.6e-3
    for r in ranks:
        for ta, ja in zip(r["slice"]["adam"], jadam):
            for k in ("m", "v"):
                rel = np.linalg.norm(ta[k] - ja[k]) / np.linalg.norm(ja[k])
                assert rel <= 1e-2, (k, rel)


def _train_bert_lamb_jax(inp, mesh):
    """The JAX package's tiny BERT under O2 + FusedLAMB + DDP, one
    shard_map step per optimizer step over the 2-device mesh."""
    jm, jopt = jamp.initialize(
        jmodels.BertForPretraining(jmodels.BertConfig(**inp["cfg"])),
        joptim.FusedLAMB(lr=inp["lr"]), opt_level="O2", verbosity=0)
    ddp = jparallel.DistributedDataParallel(
        jm, message_size=inp["message_size"])
    params = jm.cast_params(jax.tree_util.tree_map(jnp.asarray,
                                                   inp["params"]))
    ost = jopt.init(params)

    def step(st, batch):
        params, ost = st
        ids, labels, nsp, attn = batch

        def loss_fn(p):
            return jm.loss(p, ids, labels, nsp, attention_mask=attn), ()

        loss, _, grads = jamp.scaled_grad(loss_fn, params, ost,
                                          has_aux=True)
        grads = ddp.allreduce_grads(grads)
        params, ost, _ = jopt.step(params, ost, grads)
        return (params, ost), lax.pmean(loss, "data")

    train = ddp.make_step(step, mesh=mesh, donate_state=False)
    st, losses = (params, ost), []
    batch = tuple(jnp.asarray(inp[k]) for k in ("ids", "labels", "nsp",
                                                "attn"))
    for _ in range(inp["steps"]):
        st, loss = train(st, batch)
        losses.append(float(loss))
    return losses, st[1]


# BERT-large's path in small: O2 + FusedLAMB through DDP on 2 ranks
# against the JAX package's shard_map step.  The tied decoder weight is one
# parameter on both sides; the grads go out in a bf16 bucket (chunked at
# message_size 4096) and an fp32 one (the LayerNorms).  bf16 matmuls round
# apart through oneDNN and XLA (the single-process O2 tolerances of
# tests/test_torch_bert.py: measured losses within 1.7e-4, masters 4.5e-3
# of the 6.0e-3 bound 2*lr*steps*max|p|, m and v within 8.7e-3 in
# relative norm)
def test_bert_lamb_o2_ddp_two_ranks_matches_jax(ranks, ddp_inputs, mesh2):
    inp = ddp_inputs["bert_lamb"]
    jl, jost = _train_bert_lamb_jax(inp, mesh2)
    r0, r1 = (r["bert_lamb"] for r in ranks)
    for k in ("masters", "half", "m", "v"):   # the ranks stay in step
        np.testing.assert_array_equal(r0[k], r1[k], k)
    tl = np.mean([r0["losses"], r1["losses"]], axis=0)
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    names = r0["names"]
    assert sum(n.endswith("word_embeddings.weight") for n in names) == 1
    jm = np.concatenate([np.asarray(a, np.float32).ravel() for a in
                         jax.tree_util.tree_leaves(jost.masters)])
    atol = 2 * LAMB_LR * STEPS * float(np.abs(jm).max())
    np.testing.assert_allclose(r0["masters"], jm, rtol=0, atol=atol)
    lay = ChunkedFlatLayout([torch.zeros(np.asarray(a).shape) for a in
                             jax.tree_util.tree_leaves(jost.masters)])
    back = lamb_state_to_jax(LambState(
        step=torch.tensor(r0["steps"]), m=ChunkedFlat(_t(r0["m"]), lay),
        v=ChunkedFlat(_t(r0["v"]), lay)))
    for k in ("m", "v"):
        want = np.asarray(getattr(jost.inner, k).buf)
        rel = np.linalg.norm(back[k] - want) / np.linalg.norm(want)
        assert rel < 3e-2, (k, rel)
    assert r0["steps"] == int(jost.inner.step) == STEPS
    stats = {s["dtype"]: s for s in r0["stats"]}
    assert set(stats) == {"bfloat16", "float32"}
    assert sum(s["leaves"] for s in stats.values()) == len(names)
    assert sum(s["elements"] for s in stats.values()) == jm.size
    assert stats["bfloat16"]["cause"] == "chunked"
    assert stats["bfloat16"]["chunks"] == -(-stats["bfloat16"]["elements"]
                                            // inp["message_size"])


def _full_batch_jax_grads(inp):
    """The JAX package's grads of the unconverted model over the whole
    batch on one device: per leaf (in its leaf order, the flat layout's)
    and as one flat fp32 vector."""
    jm = _small_jax()
    state = jax.tree_util.tree_map(jnp.asarray, inp["state"])

    def loss_fn(p):
        out, _ = jm.apply(p, jnp.asarray(inp["x"]), state=state, train=True)
        return JF.cross_entropy(out, jnp.asarray(inp["y"]))

    g = jax.grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, inp["params"]))
    leaves = jax.tree_util.tree_flatten_with_path(g)[0]
    names = {'.'.join(str(k.key) for k in path): np.asarray(leaf)
             for path, leaf in leaves}
    return names, np.concatenate([v.ravel() for v in names.values()])


# -- load_state_dict after amp.initialize ---------------------------------------------

def _port_small():
    return models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                         device="cpu",
                         generator=torch.Generator().manual_seed(0))


def _step(model, opt, x, y):
    loss = cross_entropy(model(x), y)
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
    opt.step()
    opt.zero_grad()


def _other_weights(opt_level):
    """A state dict of new fp32 values; where the opt level casts a
    parameter to bf16, its value is one bf16 holds (as a checkpoint of that
    model would be)."""
    ref, _ = amp.initialize(_port_small(), optimizers.FusedAdam(),
                            opt_level=opt_level, verbosity=0)
    rs = np.random.RandomState(12)
    sd = {}
    for k, v in ref.state_dict().items():
        if not v.is_floating_point():
            sd[k] = v.clone()
            continue
        a = _t((rs.randn(*v.shape) * 0.1 + (1 if "running_var" in k else 0))
               .astype(np.float32))
        sd[k] = a.to(v.dtype).float() if v.dtype != torch.float32 else a
    return sd


def _load_after_initialize(opt_level, load):
    """Two runs of one step from the weights of ``_other_weights``: loaded
    before ``amp.initialize``, and loaded after it by ``load(model, sd)``;
    a one-rank DDP wraps the model in both when a group is up."""
    sd = _other_weights(opt_level)
    rs = np.random.RandomState(13)
    # 32x32: at 16x16 layer4's stride-2 conv makes a 1x1 output, and
    # oneDNN's bf16 backward of that conv differs from run to run
    x = _t(rs.randn(4, 3, 32, 32).astype(np.float32))
    y = _t(rs.randint(0, 10, 4).astype(np.int64))
    runs = []
    for load_first in (True, False):
        model = _port_small()
        if load_first:
            model.load_state_dict(sd)
        model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                    opt_level=opt_level, verbosity=0)
        wrapped = (parallel.DistributedDataParallel(model)
                   if torch.distributed.is_initialized() else model)
        if not load_first:
            load(wrapped, sd)
        _step(wrapped, opt, x, y)
        runs.append((model, opt))
    (ma, oa), (mb, ob) = runs
    assert torch.equal(oa.masters.buf, ob.masters.buf)
    if oa.masters.half is not None:
        assert torch.equal(oa.masters.half, ob.masters.half)
    assert torch.equal(oa.state.m, ob.state.m)
    assert torch.equal(oa.state.v, ob.state.v)
    for k, v in ma.state_dict().items():
        assert torch.equal(v, mb.state_dict()[k]), k


@pytest.mark.parametrize("opt_level", ["O0", "O2", "O3"])
def test_load_state_dict_after_initialize_equals_before(opt_level):
    _load_after_initialize(opt_level, lambda m, sd: m.load_state_dict(sd))


def test_load_state_dict_of_submodules_after_initialize():
    """Each top-level child loads its own part of the state dict."""
    def load(model, sd):
        for name, child in model.named_children():
            pre = name + "."
            child.load_state_dict({k[len(pre):]: v for k, v in sd.items()
                                   if k.startswith(pre)})
    _load_after_initialize("O2", load)


@pytest.fixture
def one_rank_group(tmp_path, monkeypatch):
    # the rank's own host
    monkeypatch.setenv("GLOO_SOCKET_IFNAME",
                       os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    parallel.init_process_group(init_method=f"file://{tmp_path / 'store'}",
                                world_size=1, rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_load_state_dict_through_ddp_after_initialize(one_rank_group,
                                                      opt_level):
    """A checkpoint of the DDP-wrapped model (``module.*`` keys) loaded
    through the wrapper after ``amp.initialize``, as the reference resumes."""
    _load_after_initialize(opt_level, lambda ddp, sd: ddp.load_state_dict(
        {"module." + k: v for k, v in sd.items()}))


def test_ddp_lets_its_module_and_optimizer_go(one_rank_group):
    """The wrapper's grad hooks live in the params' grad accumulators,
    where the garbage collector cannot see them: they must not keep the
    wrapper, its module and the module's optimizer alive once the caller
    drops them.  While the wrapper lives, a backward still all-reduces."""
    import gc
    import weakref
    model, opt = amp.initialize(_port_small(), optimizers.FusedAdam(),
                                opt_level="O2", verbosity=0)
    ddp = parallel.DistributedDataParallel(model)
    rs = np.random.RandomState(15)
    x = _t(rs.randn(2, 3, 32, 32).astype(np.float32))
    _step(ddp, opt, x, _t(rs.randint(0, 10, 2)))
    assert ddp.last_comm_stats
    refs = [weakref.ref(o) for o in (ddp, model, opt, opt.masters.buf)]
    del ddp, model, opt
    gc.collect()
    assert [r() for r in refs] == [None] * 4


def test_load_state_dict_after_initialize_keeps_full_precision():
    model, opt = amp.initialize(_port_small(), optimizers.FusedAdam(),
                                opt_level="O2", verbosity=0)
    rs = np.random.RandomState(14)
    sd = {k: (_t(rs.randn(*v.shape).astype(np.float32))
              if v.is_floating_point() else v.clone())
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    layout = opt.masters.layout
    for name, piece in zip(layout.names, layout.pieces(opt.masters.buf)):
        assert torch.equal(piece, sd[name]), name        # fp32, unrounded
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), sd[name].to(p.dtype)), name
    assert torch.equal(opt.masters.half,
                       opt.masters.buf.to(opt.masters.half.dtype))


def test_load_state_dict_with_assign_after_initialize_raises():
    """assign=True would swap in new tensors and cut the parameters off
    the optimizer's flat buffers."""
    model, _ = amp.initialize(_port_small(), optimizers.FusedAdam(),
                              opt_level="O2", verbosity=0)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(RuntimeError, match="assign=True"):
        model.load_state_dict(sd, assign=True)


# -- the process group -----------------------------------------------------------------

def test_init_process_group_is_a_no_op_when_unwired(monkeypatch):
    for k in (multiproc.ENV_INIT_METHOD, "MASTER_ADDR", "RANK",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_process_group() == 0
    assert not torch.distributed.is_initialized()


def test_ddp_needs_a_group_and_refuses_unported_options():
    lin = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.DistributedDataParallel(lin)
    for kw in ({"adasum": True}, {"comm_topology": "hierarchical"},
               {"allreduce_compress_bf16": True}, {"overlap": True},
               {"zero_stage": 2}, {"ici_size": 4}):
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            parallel.DistributedDataParallel(lin, **kw)
    assert parallel.predivide_factors(8, 1.0) == (1.0, 8)
    assert parallel.predivide_factors(8, 4.0) == (4.0, 2.0)


def test_launcher_fails_when_a_rank_fails(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text("import os, sys\n"
                      "sys.exit(3 if os.environ['RANK'] == '1' else 0)\n")
    assert multiproc.main(["--nprocs", "2", str(script)]) == 3
    ok = tmp_path / "ok.py"
    ok.write_text("import os\n"
                  f"assert os.environ['{multiproc.ENV_INIT_METHOD}']"
                  ".startswith('tcp://127.0.0.1:')\n"
                  "assert os.environ['WORLD_SIZE'] == '2'\n")
    assert multiproc.main(["--nprocs", "2", str(ok)]) == 0
