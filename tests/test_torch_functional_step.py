"""The functional training step of the port against the JAX package's, on
the CPU.

- ``amp.scaled_grad`` against ``apex_tpu.amp.scaled_grad`` on a tiny
  Bottleneck ResNet and a tiny BERT, at O0 and O2 (weights carried across
  by ``utils.jax_interop``, inputs from numpy seeds);
- ``amp.scaled_grad_accum`` against the JAX package's, the cases of
  ``tests/test_amp_casts.py`` (one big batch in fp32; an O2 step, and an
  inf in one micro-batch that skips it);
- ``AmpOptimizer.step(grads)`` against the JAX package's functional step
  over three steps, and bitwise against the port's own ``scale_loss``
  step (O0, O2, fp16 with an overflow, FusedLAMB);
- ``allreduce_comm_plan``'s dicts against the JAX package's on
  ResNet-50's and BERT-large's parameter shapes (shapes only);
- ``make_step`` with ``steps_per_call=3`` bitwise against three calls
  (``tests/test_ddp.py:244``).

The multi-rank ``make_step`` is ``tests/test_torch_make_step_ddp.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import nn as jnn
from apex_tpu import optimizers as joptim
from apex_tpu import parallel as jparallel
from apex_tpu.nn import functional as JF

from apex_tpu_torch import amp, models, nn, optimizers, parallel
from apex_tpu_torch.nn.functional import cross_entropy, mse_loss
from apex_tpu_torch.utils.jax_interop import params_from_jax
import torch_threads  # noqa: F401  (one torch thread a process)

LR = 1e-5
STEPS = 3
BERT_CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, head_chunk=48)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _paths(tree):
    return {'.'.join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- the two models, from the JAX package's weights ----------------------------

@pytest.fixture(scope="module")
def resnet_weights():
    params, state = jmodels.ResNet(jmodels.resnet.Bottleneck, [1, 1, 1, 1],
                                   num_classes=10).init(jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


@pytest.fixture(scope="module")
def bert_weights():
    params, _ = jmodels.BertForPretraining(
        jmodels.BertConfig(**BERT_CFG)).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _resnet_batch(seed=1, n=16):
    # 16 images: at 4, layer4's BatchNorms normalize 4 values a channel and
    # the fp32 grads of two summation orders part by 2.8e-3 (measured)
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3, 32, 32).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int32))


def _bert_batch(seed=1):
    rs = np.random.RandomState(seed)
    B, T = 4, 16
    ids = rs.randint(5, BERT_CFG["vocab_size"], (B, T))
    mask = rs.rand(B, T) < 0.15
    attn = np.ones((B, T), np.int32)
    attn[1, -4:] = 0
    return (np.where(mask & (rs.rand(B, T) < 0.8), 3, ids).astype(np.int32),
            np.where(mask, ids, -100).astype(np.int32),
            rs.randint(0, 2, (B,)).astype(np.int32), attn)


def _resnet_pair(weights, opt_level, make_opt=None, **kw):
    """The JAX model, optimizer, params, BN state and opt state, and the
    port's model and optimizer, from the same weights."""
    make_opt = make_opt or (lambda m: m.FusedAdam(lr=LR))
    jm, jopt = jamp.initialize(
        jmodels.ResNet(jmodels.resnet.Bottleneck, [1, 1, 1, 1],
                       num_classes=10), make_opt(joptim),
        opt_level=opt_level, verbosity=0, **kw)
    jparams = jm.cast_params(jax.tree_util.tree_map(jnp.asarray,
                                                    weights[0]))
    jstate = jax.tree_util.tree_map(jnp.asarray, weights[1])
    tm = models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                       device="cpu")
    tm.load_state_dict(params_from_jax(*weights), strict=True)
    tm, topt = amp.initialize(tm, make_opt(optimizers),
                              opt_level=opt_level, verbosity=0, **kw)
    return (jm, jopt, jparams, jstate, jopt.init(jparams)), (tm, topt)


def _bert_pair(weights, opt_level):
    jm, jopt = jamp.initialize(jmodels.BertForPretraining(
        jmodels.BertConfig(**BERT_CFG)), joptim.FusedAdam(lr=LR),
        opt_level=opt_level, verbosity=0)
    jparams = jm.cast_params(jax.tree_util.tree_map(jnp.asarray, weights))
    tm = models.BertForPretraining(models.BertConfig(**BERT_CFG),
                                   device="cpu")
    tm.load_state_dict(params_from_jax(weights), strict=True)
    tm, topt = amp.initialize(tm, optimizers.FusedAdam(lr=LR),
                              opt_level=opt_level, verbosity=0)
    return (jm, jopt, jparams, None, jopt.init(jparams)), (tm, topt)


# -- scaled_grad ------------------------------------------------------------------

def _scaled_grads(model_name, weights, opt_level):
    """One scaled_grad on each side: (loss, grads by name, scale) for the
    JAX package and the port, and the port's names in layout order."""
    if model_name == "resnet":
        (jm, _, jp, js, jost), (tm, topt) = _resnet_pair(weights, opt_level)
        x, y = _resnet_batch()
        def jfn(p, ost):
            def loss_fn(pp):
                out, _ = jm.apply(pp, jnp.asarray(x), state=js, train=True)
                return JF.cross_entropy(out, jnp.asarray(y)), out
            return jamp.scaled_grad(loss_fn, p, ost, has_aux=True)
        jloss, jaux, jg = jax.jit(jfn)(jp, jost)
        tloss, taux, tg = amp.scaled_grad(
            lambda a, b: (lambda o: (cross_entropy(o, b), o))(tm(a)), topt,
            _t(x), _t(y).long(), has_aux=True)
        assert not taux.requires_grad
        # the logits, in relative norm: fp32 sums in other orders at O0
        # (measured 1.2e-5), bf16 convolutions rounded on each side at O2
        # (measured 4.3e-2)
        rel = _rel(_np(taux), np.asarray(jaux, np.float32))
        assert rel <= (1e-4 if opt_level == "O0" else 0.1), rel
    else:
        (jm, _, jp, _, jost), (tm, topt) = _bert_pair(weights, opt_level)
        ids, labels, nsp, attn = _bert_batch()
        with pytest.MonkeyPatch.context() as mp:
            # the JAX package's Pallas kernels, in interpret mode
            mp.setenv("APEX_TPU_FORCE_PALLAS", "1")
            mp.delenv("APEX_TPU_DISABLE_PALLAS", raising=False)
            jloss, jg = jax.jit(lambda p, ost: jamp.scaled_grad(
                lambda pp: jm.loss(pp, *map(jnp.asarray, (ids, labels, nsp)),
                                   attention_mask=jnp.asarray(attn)),
                p, ost))(jp, jost)
        tloss, tg = amp.scaled_grad(
            lambda: tm.loss(*map(_t, (ids, labels, nsp)),
                            attention_mask=_t(attn)), topt)
    names = topt.masters.layout.names
    assert len(tg) == len(names)
    for g, p in zip(tg, topt._params):
        assert g.shape == p.shape and g.dtype == p.dtype
        assert p.grad is None          # nothing accumulated into .grad
    return ((float(jloss), _paths(jg), float(jost.scalers[0].loss_scale)),
            (float(tloss), dict(zip(names, tg)),
             float(topt.scalers[0].loss_scale)))


# loss: fp32 on both sides at O0 (the sums in other orders); at O2 the
# convolutions and matmuls run in bf16 through oneDNN here and XLA there
# (tests/test_torch_resnet.py, tests/test_torch_bert.py: measured up to
# 8.8e-3 and 2.8e-4 over three steps).  Grads, unscaled on each side, as
# one vector in relative norm: at O0 the order of the sums alone (ResNet
# measured 5.9e-6); at O2 the ResNet's bf16 convolutions round on each side
# on their own (measured 0.23; tests/test_torch_resnet.py: 24-48 %).
@pytest.mark.parametrize("model_name,opt_level,loss_rtol,grad_rel", [
    ("resnet", "O0", 1e-5, 1e-4), ("resnet", "O2", 2e-2, 0.5),
    ("bert", "O0", 1e-5, 1e-4), ("bert", "O2", 1e-2, 5e-2)])
def test_scaled_grad_matches_jax(resnet_weights, bert_weights, model_name,
                                 opt_level, loss_rtol, grad_rel):
    weights = resnet_weights if model_name == "resnet" else bert_weights
    (jl, jg, js), (tl, tg, ts) = _scaled_grads(model_name, weights,
                                               opt_level)
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    assert set(tg) == set(jg)
    for n in tg:
        assert str(tg[n].dtype).replace("torch.", "") == str(jg[n].dtype), n
    t = np.concatenate([_np(tg[n]).ravel() / ts for n in sorted(tg)])
    j = np.concatenate([np.asarray(jg[n], np.float32).ravel() / js
                        for n in sorted(tg)])
    assert np.all(np.isfinite(t))
    assert _rel(t, j) <= grad_rel, _rel(t, j)


# -- scaled_grad_accum (tests/test_amp_casts.py:231, :248) -----------------------

def _accum_setup(opt_level):
    net = jnn.Sequential([jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4)])
    jmodel, jopt = jamp.initialize(net, joptim.FusedAdam(lr=1e-2),
                                   opt_level=opt_level, verbosity=0,
                                   hard_override=True)
    params, _ = net.init(jax.random.PRNGKey(0))
    g = torch.Generator().manual_seed(0)
    tnet = torch.nn.Sequential(nn.Linear(8, 16, device="cpu", generator=g),
                               torch.nn.ReLU(),
                               nn.Linear(16, 4, device="cpu", generator=g))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)))
    tmodel, topt = amp.initialize(tnet, optimizers.FusedAdam(lr=1e-2),
                                  opt_level=opt_level, verbosity=0,
                                  hard_override=True)
    jparams = jmodel.cast_params(params)
    rng = np.random.RandomState(0)
    x = rng.randn(12, 8).astype(np.float32)
    y = rng.randn(12, 4).astype(np.float32)

    def jloss(p, mb):
        out, _ = jmodel.apply(p, mb[0])
        return JF.mse_loss(out, mb[1])

    def tloss(mb):
        return mse_loss(tmodel(mb[0]), mb[1])

    return (jmodel, jopt, jparams, jopt.init(jparams), jloss), \
        (tmodel, topt, tloss), x, y


def _flat(grads) -> np.ndarray:
    return np.concatenate([np.asarray(_np(g) if isinstance(g, torch.Tensor)
                                      else g, np.float32).ravel()
                           for g in grads])


def test_scaled_grad_accum_matches_big_batch_fp32():
    """Three micro-batches of 4 against one batch of 12 at O0, in the port
    and against the JAX package's accumulation (atol 2e-6, the JAX
    test's: fp32 sums in other orders)."""
    (_, _, jp, jost, jloss), (_, topt, tloss), x, y = _accum_setup("O0")
    micro = (x.reshape(3, 4, 8), y.reshape(3, 4, 4))
    jl, jg = jamp.scaled_grad_accum(jloss, jp, jost,
                                    tuple(map(jnp.asarray, micro)))
    tl, tg = amp.scaled_grad_accum(tloss, topt, tuple(map(_t, micro)))
    bl, bg = amp.scaled_grad(lambda: tloss((_t(x), _t(y))), topt)
    assert all(g.dtype == torch.float32 for g in tg)
    np.testing.assert_allclose(float(tl), float(bl), rtol=1e-6)
    np.testing.assert_allclose(_flat(tg), _flat(bg), atol=2e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(_flat(tg), _flat(jax.tree_util.tree_leaves(
        jg)), atol=2e-6)
    # the sum convention
    sl, sg = amp.scaled_grad_accum(tloss, topt, tuple(map(_t, micro)),
                                   average=False)
    np.testing.assert_allclose(float(sl), 3 * float(tl), rtol=1e-6)
    np.testing.assert_allclose(_flat(sg), 3 * _flat(tg), rtol=1e-6,
                               atol=1e-6)


def test_scaled_grad_accum_o2_step_and_overflow():
    """Under O2 the accumulated grads feed one step (bf16 matmuls through
    oneDNN and XLA round apart: the JAX test's atol 1e-3, rtol 0.05); an
    inf in one micro-batch survives the fp32 sum, sets the step's
    overflow flag and skips it, the params bitwise, in both packages."""
    (_, jopt, jp, jost, jloss), (tm, topt, tloss), x, y = \
        _accum_setup("O2")
    micro = (x.reshape(3, 4, 8), y.reshape(3, 4, 4))
    _, jg = jamp.scaled_grad_accum(jloss, jp, jost,
                                   tuple(map(jnp.asarray, micro)))
    _, tg = amp.scaled_grad_accum(tloss, topt, tuple(map(_t, micro)))
    js, ts = float(jost.scalers[0].loss_scale), float(topt.loss_scale())
    np.testing.assert_allclose(_flat(tg) / ts, _flat(
        jax.tree_util.tree_leaves(jg)) / js, atol=1e-3, rtol=0.05)
    _, _, info = jopt.step(jp, jost, jg)
    tinfo = topt.step(tg)
    assert float(info["found_inf"]) == float(tinfo["found_inf"]) == 0.0
    bad = micro[0].copy()
    bad[1] = np.inf
    _, jbad = jamp.scaled_grad_accum(jloss, jp, jost,
                                     (jnp.asarray(bad), jnp.asarray(micro[1])))
    p3, _, info3 = jopt.step(jp, jost, jbad)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    masters = topt.masters.buf.clone()
    scale = float(topt.loss_scale())
    _, tbad = amp.scaled_grad_accum(tloss, topt, (_t(bad), _t(micro[1])))
    tinfo3 = topt.step(tbad)
    assert float(info3["found_inf"]) > 0 and float(tinfo3["found_inf"]) > 0
    for a, b in zip(jax.tree_util.tree_leaves(p3),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    assert torch.equal(topt.masters.buf, masters)
    if topt.scaler.dynamic:
        assert float(topt.loss_scale()) == scale / 2


# -- the functional optimizer step --------------------------------------------------

def _jax_functional(jm, jopt, jp, js, jost, x, y):
    @jax.jit
    def step(params, state, ost):
        def loss_fn(p):
            out, new_state = jm.apply(p, x, state=state, train=True)
            return JF.cross_entropy(out, y), new_state
        loss, new_state, grads = jamp.scaled_grad(loss_fn, params, ost,
                                                  has_aux=True)
        params, ost, info = jopt.step(params, ost, grads)
        return params, new_state, ost, loss, info

    losses = []
    for _ in range(STEPS):
        jp, js, jost, loss, info = step(jp, js, jost)
        losses.append(float(loss))
    return losses, jp, js, jost, info


def _port_functional(tm, topt, x, y):
    losses, info = [], None
    for _ in range(STEPS):
        loss, grads = amp.scaled_grad(lambda: cross_entropy(tm(x), y), topt)
        info = topt.step(grads)
        losses.append(float(loss))
    return losses, info


# the tolerances of tests/test_torch_resnet.py's training slice (see there):
# losses 1e-4 at O0 and 2e-2 at O2; masters 2*lr a step plus the fp32
# rounding of the largest; BN running statistics 1e-4 / 5e-2 in relative
# norm.  info's grad norm: at 4 images layer4's BatchNorms normalize 4
# values a channel and the fp32 grads of two summation orders part by
# 2.8e-3 (measured 2.9e-3 on the norm at step 3), at O2 by the bf16
# distance of the grads themselves
@pytest.mark.parametrize("opt_level,loss_rtol,stats_rtol,norm_rtol",
                         [("O0", 1e-4, 1e-4, 1e-2), ("O2", 2e-2, 5e-2, 0.5)])
def test_functional_step_matches_jax(resnet_weights, opt_level, loss_rtol,
                                     stats_rtol, norm_rtol):
    (jm, jopt, jp, js, jost), (tm, topt) = _resnet_pair(resnet_weights,
                                                        opt_level)
    x, y = _resnet_batch(n=4)
    jl, jp, js, jost, jinfo = _jax_functional(jm, jopt, jp, js, jost,
                                              jnp.asarray(x), jnp.asarray(y))
    tl, tinfo = _port_functional(tm, topt, _t(x), _t(y).long())
    # the caller's own copy of the last step's info, which the optimizer's
    # buffer matches until the next step rewrites it
    assert tinfo is not topt.last_info
    assert tinfo.keys() == topt.last_info.keys()
    for k, t in tinfo.items():
        assert t is not topt.last_info[k] and torch.equal(
            t, topt.last_info[k]), k
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    for k in ("found_inf", "loss_scale", "steps_skipped"):
        assert float(tinfo[k]) == float(jinfo[k]), k
    np.testing.assert_allclose(float(tinfo["grad_norm"]),
                               float(jinfo["grad_norm"]), rtol=norm_rtol)
    if opt_level == "O2":
        tmast, jmast = topt.masters.buf.numpy(), np.asarray(jost.masters.buf)
    else:
        jpp = _paths(jp)
        tmast = np.concatenate([_np(p).ravel()
                                for _, p in tm.named_parameters()])
        jmast = np.concatenate([np.asarray(jpp[n]).ravel()
                                for n, _ in tm.named_parameters()])
    atol = 2 * LR * STEPS + 4 * float(np.spacing(np.abs(jmast).max()))
    np.testing.assert_allclose(tmast, jmast, rtol=0, atol=atol)
    assert int(topt.state.step) == int(jost.inner.step) == STEPS
    sd = tm.state_dict()
    worst = max(_rel(sd[f"{path}.{k}"].numpy(), leaves[k])
                for path, leaves in js.items()
                for k in ("running_mean", "running_var"))
    assert worst <= stats_rtol, worst


# two steps' infos: each its own, equal to the JAX step's info of that
# step (found_inf, loss_scale and steps_skipped exactly, grad_norm at the
# rtol of test_functional_step_matches_jax) and bitwise to last_info as it
# stood right after that step; each step a fresh batch, so that the grad
# norms of the two steps differ
@pytest.mark.parametrize("opt_level,norm_rtol", [("O0", 1e-2), ("O2", 0.5)])
def test_functional_step_infos_are_the_callers_own(resnet_weights,
                                                    opt_level, norm_rtol):
    (jm, jopt, jp, js, jost), (tm, topt) = _resnet_pair(resnet_weights,
                                                        opt_level)
    batches = [_resnet_batch(seed=11 + i, n=4) for i in range(2)]

    @jax.jit
    def jstep(params, state, ost, x, y):
        def loss_fn(p):
            out, new_state = jm.apply(p, x, state=state, train=True)
            return JF.cross_entropy(out, y), new_state
        _, new_state, grads = jamp.scaled_grad(loss_fn, params, ost,
                                               has_aux=True)
        params, ost, info = jopt.step(params, ost, grads)
        return params, new_state, ost, info

    jinfos, tinfos, snaps = [], [], []
    for x, y in batches:
        jp, js, jost, info = jstep(jp, js, jost, jnp.asarray(x),
                                   jnp.asarray(y))
        jinfos.append(info)
        _, grads = amp.scaled_grad(
            lambda: cross_entropy(tm(_t(x)), _t(y).long()), topt)
        tinfos.append(topt.step(grads))
        snaps.append({k: t.clone() for k, t in topt.last_info.items()})
    assert tinfos[0] is not tinfos[1]
    assert tinfos[0]["grad_norm"] is not tinfos[1]["grad_norm"]
    assert float(tinfos[0]["grad_norm"]) != float(tinfos[1]["grad_norm"])
    for tinfo, snap, jinfo in zip(tinfos, snaps, jinfos):
        assert tinfo.keys() == snap.keys() == set(jinfo)
        for k in tinfo:
            assert torch.equal(tinfo[k], snap[k]), k
        for k in ("found_inf", "loss_scale", "steps_skipped"):
            assert float(tinfo[k]) == float(jinfo[k]), k
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=norm_rtol)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaNs in the same places counting as equal."""
    return (a.dtype == b.dtype and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _state(model, opt):
    out = {"masters": opt.masters.buf.clone()}
    if opt.masters.half is not None:
        out["half"] = opt.masters.half.clone()
    for k, v in opt.state_dict()["inner"].items():
        if isinstance(v, torch.Tensor):
            out[k] = v.clone()
    for i, s in enumerate(opt.scalers_state_dict()):
        out.update({f"scaler{i}.{k}": t.clone() for k, t in s.items()})
    out.update({f"buf.{k}": b.clone() for k, b in model.named_buffers()})
    out.update({f"info.{k}": t.clone() for k, t in opt.last_info.items()})
    return out


# every tensor of the state and every loss bitwise: the functional step and
# the scale_loss step run the same ops on the same grads; an inf planted in
# the last step's input skips it on both (BatchNorm's statistics turn NaN
# alike: NaNs compare equal by place); the other steps take fresh batches
@pytest.mark.parametrize("opt_level,half,lamb", [
    ("O0", None, False), ("O2", None, False), ("O2", "float16", False),
    ("O2", None, True)])
def test_functional_step_equals_scale_loss_step_bitwise(
        resnet_weights, opt_level, half, lamb):
    make = (lambda m: m.FusedLAMB(lr=1e-3)) if lamb else None
    kw = {"half_dtype": half} if half else {}
    pairs = [_resnet_pair(resnet_weights, opt_level, make, **kw)[1]
             for _ in range(2)]
    (ta, oa), (tb, ob) = pairs
    x, y = _resnet_batch(n=4)
    x, y = _t(x), _t(y).long()
    bad = x.clone()
    bad[0, 0, 0, 0] = float("inf")
    found = []
    for i in range(4):
        x = bad if i == 3 else _t(_resnet_batch(n=4)[0])
        la = cross_entropy(ta(x), y)
        with amp.scale_loss(la, oa) as scaled:
            scaled.backward()
        oa.step()
        oa.zero_grad()
        lb, grads = amp.scaled_grad(lambda: cross_entropy(tb(x), y), ob)
        info = ob.step(grads)
        found.append(float(info["found_inf"]))
        assert la.detach().numpy().tobytes() == lb.numpy().tobytes()
        sa, sb = _state(ta, oa), _state(tb, ob)
        assert sa.keys() == sb.keys()
        for k in sa:
            assert _same(sa[k], sb[k]), k
    # fp16's dynamic scale from 2**16 also skips the first steps
    assert found[3] == 1.0 and (half == "float16" or sum(found) == 1.0)


# -- allreduce_comm_plan (shapes only) ----------------------------------------------

def _shapes(jmodel, opt_level):
    """The JAX model's cast parameter shapes under ``opt_level``, and the
    same as a name -> meta tensor mapping for the port."""
    jm, _ = jamp.initialize(jmodel, joptim.FusedAdam(), opt_level=opt_level,
                            verbosity=0)
    params, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = jax.eval_shape(jm.cast_params, params)
    meta = {n: torch.empty(l.shape, device="meta",
                           dtype=getattr(torch, str(l.dtype)))
            for n, l in _paths(params).items()}
    return params, meta


PLAN_CASES = {
    "default": ({}, {}),
    "fp32_chunked": ({"allreduce_always_fp32": True,
                      "message_size": 1_000_000}, None),
    "chunked": ({"message_size": 3_000_000}, None),
    "delay": ({"delay_allreduce": True, "message_size": 1_000_000}, None),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("arch", ["resnet50", "bert_large"])
def test_comm_plan_matches_jax(arch, case):
    jmodel = (jmodels.resnet50() if arch == "resnet50" else
              jmodels.BertForPretraining(jmodels.bert_large()))
    params, meta = _shapes(jmodel, "O2")
    kwargs = PLAN_CASES[case][0]
    want = jparallel.allreduce_comm_plan(params, **kwargs)
    got = parallel.allreduce_comm_plan(meta, **kwargs)
    assert got == want
    assert sum(b["elements"] for b in got) == sum(
        t.numel() for t in meta.values())
    if arch == "bert_large" and case == "default":
        # the LayerNorms' fp32 bucket (the first leaf's dtype), then the
        # bf16 one in 34 chunks of 10**7
        assert [(b["dtype"], b["chunks"]) for b in got] == [
            ("float32", 1), ("bfloat16", 34)]


def test_comm_plan_triggers_match_jax():
    params, meta = _shapes(jmodels.resnet50(), "O0")
    trig = {"layer2.0.conv1.weight", "layer4.2.bn3.bias"}
    # the JAX package's paths join the keys with "/"
    want = jparallel.allreduce_comm_plan(
        params, trigger_paths={t.replace(".", "/") for t in trig})
    assert parallel.allreduce_comm_plan(meta, trigger_paths=trig) == want
    assert len(want) == 3


def test_comm_plan_hierarchical_raises_naming_the_roadmap():
    """The hierarchical plan is ported (the JAX package's, bucket for
    bucket); what still raises names its ROADMAP item: the analysis
    expectations built on the plan (item 10), and compression on the flat
    topology is refused as the JAX package refuses it."""
    params, meta = _shapes(jmodels.resnet50(), "O2")
    for kw in ({"comm_topology": "hierarchical", "world": 8},
               {"comm_topology": "hierarchical", "world": 8, "ici_size": 4,
                "allreduce_compress_bf16": True},
               {"ici_size": 4}):
        assert parallel.allreduce_comm_plan(meta, **kw) == \
            jparallel.allreduce_comm_plan(params, **kw)
    with pytest.raises(ValueError, match="no inner level"):
        parallel.allreduce_comm_plan(meta, allreduce_compress_bf16=True)
    assert parallel.plan_collective_expectations(
        parallel.allreduce_comm_plan(meta), extra_psums=2,
        extra_psum_bytes=8) == jparallel.plan_collective_expectations(
            jparallel.allreduce_comm_plan(params), extra_psums=2,
            extra_psum_bytes=8)


# -- make_step (tests/test_ddp.py:244) ----------------------------------------------

def test_make_step_steps_per_call_matches_sequential(resnet_weights):
    """K steps in one call equal K calls bitwise: losses (stacked on a
    leading K axis), the whole optimizer state and BN's statistics."""
    K = 3
    pairs = [_resnet_pair(resnet_weights, "O2")[1] for _ in range(2)]
    rs = np.random.RandomState(3)
    xs = _t(rs.randn(K, 4, 3, 32, 32).astype(np.float32))
    ys = _t(rs.randint(0, 10, (K, 4)).astype(np.int64))

    def stepper(tm, topt):
        def step(batch):
            x, y = batch
            loss, grads = amp.scaled_grad(lambda: cross_entropy(tm(x), y),
                                          topt)
            info = topt.step(grads)
            return {"loss": loss, "scale": info["loss_scale"].clone()}
        return step

    (ta, oa), (tb, ob) = pairs
    one = parallel.make_step(stepper(ta, oa), ta)
    seq = [one((xs[i], ys[i])) for i in range(K)]
    multi = parallel.make_step(stepper(tb, ob), tb, steps_per_call=K)
    out = multi((xs, ys))
    assert out["loss"].shape == (K,) and out["scale"].shape == (K,)
    assert torch.equal(out["loss"], torch.stack([s["loss"] for s in seq]))
    sa, sb = _state(ta, oa), _state(tb, ob)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert int(ob.state.step) == K
    with pytest.raises(ValueError, match=r"\(K, per_step"):
        multi((xs[:2], ys[:2]))
    with pytest.raises(ValueError, match="donate_state"):
        parallel.make_step(stepper(ta, oa), ta, donate_state=False)
    with pytest.raises(ValueError, match="steps_per_call"):
        parallel.make_step(stepper(ta, oa), ta, steps_per_call=0)


@pytest.mark.parametrize("K", [1, 2])
def test_make_step_returns_copies_on_the_cpu(resnet_weights, K):
    """The step returns the optimizer's info as it is; ``make_step``'s
    calls return copies: call 1's tensors are unchanged by call 2, and
    with K = 2 each row of a call is its own step's info (each step a
    fresh batch), bitwise the optimizer's last_info right after it."""
    tm, topt = _resnet_pair(resnet_weights, "O2")[1]
    snaps = []

    def step(batch):
        x, y = batch
        loss, grads = amp.scaled_grad(lambda: cross_entropy(tm(x), y), topt)
        info = topt.step(grads)
        snaps.append({k: t.clone() for k, t in topt.last_info.items()})
        return dict(info, loss=loss)

    train = parallel.make_step(step, tm, steps_per_call=K)
    rs = np.random.RandomState(21)

    def batch():
        shape = (K, 4) if K > 1 else (4,)
        return (_t(rs.randn(*shape, 3, 32, 32).astype(np.float32)),
                _t(rs.randint(0, 10, shape).astype(np.int64)))

    outs = [train(batch()) for _ in range(2)]
    firsts = {k: t.clone() for k, t in outs[0].items()}
    for k in topt.last_info:
        assert outs[0][k] is not topt.last_info[k], k
        assert torch.equal(outs[0][k], firsts[k]), k
    for call, out in enumerate(outs):
        mine = snaps[call * K:(call + 1) * K]
        for k in topt.last_info:
            want = (mine[0][k] if K == 1
                    else torch.stack([m[k] for m in mine]))
            assert torch.equal(out[k], want), (call, k)
    norms = [float(m["grad_norm"]) for m in snaps]
    assert len(set(norms)) == len(norms) == 2 * K
