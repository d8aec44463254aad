"""The port's legacy fp16 toolkit (``apex_tpu_torch.fp16_utils``) against
the JAX package's, on the CPU: the seven cases of tests/test_fp16_utils.py,
the legacy ``DynamicLossScaler``'s scale sequence under a scripted
overflow pattern (exactly the JAX one's), the legacy ``FP16_Optimizer``'s
steps, overflow skips and closure retry loop against the JAX one's, and
its checkpoint.

Inputs come from numpy seeds.  The model is two fp16 tensors, as in the
JAX test; fp16 matmuls round apart in the two packages (oneDNN against
XLA), so parameters after a step agree to one fp16 ulp of their values
(rtol 1e-3), loss scales exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import nn as jnn
from apex_tpu import optimizers as joptim
from apex_tpu.fp16_utils import DynamicLossScaler as JDynamicLossScaler
from apex_tpu.fp16_utils import FP16_Optimizer as JFP16_Optimizer
from apex_tpu.fp16_utils import FP16Model as JFP16Model
from apex_tpu.fp16_utils import clip_grad_norm as jclip_grad_norm
from apex_tpu.fp16_utils import master_params_to_model_params as jm2m
from apex_tpu.fp16_utils import prep_param_lists as jprep

from apex_tpu_torch import nn, optimizers
from apex_tpu_torch.fp16_utils import (DynamicLossScaler, FP16_Optimizer,
                                       FP16Model, Fused_Weight_Norm,
                                       LossScaler, clip_grad_norm,
                                       master_params_to_model_params,
                                       model_grads_to_master_grads,
                                       network_to_half, prep_param_lists,
                                       tofp16)

RTOL = 1e-3       # one fp16 ulp is 2**-10 of the value


def _np_params(seed=0):
    rs = np.random.RandomState(seed)
    return {"b": np.zeros(4, np.float16),
            "w": rs.randn(4, 3).astype(np.float16)}


def _torch_params(p):
    # the JAX tree's leaf order (sorted keys): b, w
    return [torch.nn.Parameter(torch.from_numpy(p[k].copy()))
            for k in sorted(p)]


def _x(seed=1):
    return np.random.RandomState(seed).randn(5, 3).astype(np.float16)


def _loss(params, x):
    b, w = params
    return torch.sum((x @ w.t() + b) ** 2).float()


def _jloss(p, x):
    return jnp.sum((x @ p["w"].T.astype(x.dtype) + p["b"]) ** 2
                   ).astype(jnp.float32)


def test_prep_param_lists_masters_fp32():
    p = _np_params()
    params = _torch_params(p)
    model_p, masters = prep_param_lists(params)
    assert all(m.dtype == torch.float32 for m in masters)
    _, jmasters = jprep({k: jnp.asarray(v) for k, v in p.items()})
    for m, k in zip(masters, sorted(p)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jmasters[k]))
    _, flat = prep_param_lists(params, flat_master=True)
    _, jflat = jprep({k: jnp.asarray(v) for k, v in p.items()},
                     flat_master=True)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    with pytest.raises(TypeError, match="single param dtype"):
        prep_param_lists([params[0], params[1].float()], flat_master=True)
    # the model's grads into the masters' fp32 structure (and their .grad)
    for p_ in params:
        p_.grad = torch.ones_like(p_)
    g = model_grads_to_master_grads([p_.grad for p_ in params], masters)
    assert all(t.dtype == torch.float32 for t in g)
    assert masters[1].grad is g[1]


def test_master_to_model_roundtrip():
    p = _np_params()
    params = _torch_params(p)
    _, masters = prep_param_lists(params)
    masters = [m + 0.25 for m in masters]
    out = master_params_to_model_params(masters, params)
    assert out[0] is params[0] and params[0].dtype == torch.float16
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, jm = jprep(jp)
    jnew = jm2m(jax.tree_util.tree_map(lambda m: m + 0.25, jm), jp)
    for t, k in zip(params, sorted(p)):
        np.testing.assert_array_equal(t.detach().numpy(),
                                      np.asarray(jnew[k]))
    np.testing.assert_array_equal(params[0].detach().float().numpy(),
                                  0.25 * np.ones(4))
    # the flat form writes the same values
    _, flat = prep_param_lists(params, flat_master=True)
    master_params_to_model_params(flat + 1.0, params, flat_master=True)
    np.testing.assert_array_equal(params[0].detach().float().numpy(),
                                  1.25 * np.ones(4))


def test_fp16model_keeps_batchnorm_fp32():
    g = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(nn.Conv2d(3, 4, 3, generator=g),
                                nn.BatchNorm2d(4), nn.ReLU(),
                                nn.Flatten(), nn.Linear(4, 2, generator=g))
    fm = FP16Model(model)
    for name, prm in fm.named_parameters():
        want = torch.float32 if ".1." in name else torch.float16
        assert prm.dtype == want, name
    out = fm(torch.randn(2, 3, 3, 3, generator=g))
    assert out.dtype == torch.float16
    # the JAX package keeps the same leaves fp32
    jm = JFP16Model(jnn.Sequential([jnn.Conv2d(3, 4, 3), jnn.BatchNorm2d(4),
                                    jnn.ReLU(), jnn.Linear(4, 2)]))
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    for i in ("0", "1"):
        for k, v in jparams[i].items():
            assert v.dtype == (jnp.float32 if i == "1" else jnp.float16)
    assert network_to_half(torch.nn.Sequential(nn.BatchNorm2d(2))
                           )[0].weight.dtype == torch.float32
    assert tofp16([torch.ones(2), torch.ones(2, dtype=torch.int64)]
                  )[1].dtype == torch.int64


@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 3.0])
def test_clip_grad_norm_matches_jax(norm_type):
    rs = np.random.RandomState(3)
    a = (rs.randn(3) * 3).astype(np.float32)
    b = (rs.randn(4) * 4).astype(np.float32)
    grads = [torch.from_numpy(a.copy()), torch.from_numpy(b.copy())]
    total = clip_grad_norm(grads, max_norm=1.0, norm_type=norm_type)
    jclipped, jtotal = jclip_grad_norm({"a": jnp.asarray(a),
                                        "b": jnp.asarray(b)}, 1.0, norm_type)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jclipped["a"]),
                               rtol=1e-6)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jclipped["b"]),
                               rtol=1e-6)
    if norm_type == 2.0:
        new = float(torch.sqrt(sum((g ** 2).sum() for g in grads)))
        assert abs(new - 1.0) < 1e-5
    # under max_norm nothing moves
    small = [torch.full((3,), 1e-3)]
    clip_grad_norm(small, max_norm=1.0, norm_type=norm_type)
    assert torch.equal(small[0], torch.full((3,), 1e-3))


def test_dynamic_loss_scaler_state_machine():
    s = DynamicLossScaler(init_scale=2 ** 8, scale_window=4)
    assert s.loss_scale == 2 ** 8
    s.update_scale(overflow=True)
    assert s.loss_scale == 2 ** 7
    for _ in range(4):
        s.update_scale(overflow=False)
    assert s.loss_scale == 2 ** 8
    assert s.has_overflow([torch.tensor([1.0, float("inf")])])
    assert s.has_overflow(torch.tensor([float("nan")], dtype=torch.float16))
    assert not s.has_overflow([torch.tensor([1.0, 2.0])])
    assert not LossScaler(4.0).has_overflow([torch.tensor([float("inf")])])
    assert LossScaler(4.0).scale_gradient([torch.ones(2)])[0][0] == 4.0


def test_dynamic_loss_scaler_sequence_is_the_jax_one():
    """A scripted pattern: overflow bursts, clean runs across the window,
    the floor at 1.0 (thirty overflows in a row) and the growth counted
    from the last overflow, each iteration's scale exactly the JAX
    scaler's."""
    pattern = ([True, False, False, False, True, True] + [False] * 9
               + [True] * 30 + [False] * 7 + [True, False, False, False])
    for window in (1, 3, 4):
        ours = DynamicLossScaler(init_scale=2 ** 20, scale_window=window)
        jax_s = JDynamicLossScaler(init_scale=2 ** 20, scale_window=window)
        seq, jseq = [], []
        for over in pattern:
            ours.update_scale(over)
            jax_s.update_scale(over)
            seq.append((ours.cur_scale, ours.cur_iter,
                        ours.last_overflow_iter))
            jseq.append((jax_s.cur_scale, jax_s.cur_iter,
                         jax_s.last_overflow_iter))
        assert seq == jseq
        assert min(s for s, _, _ in seq) == 1.0


def test_loss_scaler_backward_scales_the_grads():
    p = torch.nn.Parameter(torch.ones(3))
    LossScaler(8.0).backward((p * 2.0).sum())
    assert torch.equal(p.grad, torch.full((3,), 16.0))


def _pair(inner, jinner, **kw):
    p = _np_params()
    params = _torch_params(p)
    opt = FP16_Optimizer(inner, verbose=False, **kw)
    opt.setup(params)
    jopt = JFP16_Optimizer(jinner, verbose=False, **kw)
    jopt.setup({k: jnp.asarray(v) for k, v in p.items()})
    return params, opt, jopt


def _same_params(params, jopt):
    for t, k in zip(params, ("b", "w")):
        np.testing.assert_allclose(
            t.detach().float().numpy(),
            np.asarray(jopt.params[k], np.float32), rtol=RTOL, atol=1e-3)


@pytest.mark.parametrize("which", ["sgd", "adam"])
def test_fp16_optimizer_step_and_overflow_skip(which):
    mk = {"sgd": (lambda: optimizers.SGD(lr=0.1),
                  lambda: joptim.SGD(lr=0.1)),
          "adam": (lambda: optimizers.FusedAdam(lr=1e-2),
                   lambda: joptim.FusedAdam(lr=1e-2))}[which]
    params, opt, jopt = _pair(mk[0](), mk[1](), dynamic_loss_scale=True,
                              dynamic_loss_args={"init_scale": 2.0 ** 8})
    x = _x()
    before = params[1].detach().clone()
    opt.backward(_loss(params, torch.from_numpy(x)))
    jloss = jopt.backward(_jloss, jnp.asarray(x))
    assert not opt.overflow and not jopt.overflow and jnp.isfinite(jloss)
    np.testing.assert_allclose(
        opt._master_grads.numpy(),
        np.concatenate([np.asarray(jopt._master_grads[k]).ravel()
                        for k in ("b", "w")]), rtol=RTOL, atol=1e-3)
    opt.step()
    jopt.step()
    assert not torch.equal(params[1].detach(), before)
    _same_params(params, jopt)
    if which == "adam":
        # the model's half params are the Adam kernel's half output
        assert params[1].data_ptr() == opt._half[4:].data_ptr()
    # overflow: an inf in the loss; the step is skipped, the scale halves
    scale = opt.loss_scale
    assert scale == jopt.loss_scale
    at = [t.detach().clone() for t in params]
    masters = opt.masters.clone()
    opt.backward(_loss(params, torch.from_numpy(x)) * float("inf"))
    jopt.backward(lambda p, x: _jloss(p, x) * jnp.float32(jnp.inf),
                  jnp.asarray(x))
    assert opt.overflow and jopt.overflow
    opt.step()
    jopt.step()
    for a, t in zip(at, params):
        assert torch.equal(a, t.detach())
    assert torch.equal(masters, opt.masters)
    assert opt.loss_scale == jopt.loss_scale == scale / 2


def test_fp16_optimizer_grads_accumulate_and_clip():
    """Two backward passes before one update of the master grads sum
    their grads (the JAX package's ``update_master_grads=False`` form);
    the clip against the JAX one's."""
    params, opt, jopt = _pair(optimizers.SGD(lr=0.1), joptim.SGD(lr=0.1),
                              static_loss_scale=64.0)
    x1, x2 = _x(1), _x(2)
    for x in (x1, x2):
        opt.backward(_loss(params, torch.from_numpy(x)),
                     update_master_grads=False)
        jopt.backward(_jloss, jnp.asarray(x), update_master_grads=False)
    opt.update_master_grads()
    jopt.update_master_grads()
    norm, jnorm = opt.clip_master_grads(0.5), jopt.clip_master_grads(0.5)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    opt.step()
    jopt.step()
    _same_params(params, jopt)
    with pytest.raises(RuntimeError, match="backward"):
        opt.clip_master_grads(1.0)


def test_fp16_optimizer_closure_retry_loop():
    """A closure whose first two evaluations overflow: the scale halves at
    each, then the step applies, as the JAX loop does."""
    params, opt, jopt = _pair(optimizers.SGD(lr=0.1), joptim.SGD(lr=0.1),
                              dynamic_loss_scale=True,
                              dynamic_loss_args={"init_scale": 2.0 ** 10})
    x = _x()
    calls = {"port": 0, "jax": 0}

    def closure():
        calls["port"] += 1
        opt.zero_grad()
        bad = float("inf") if calls["port"] <= 2 else 1.0
        loss = _loss(params, torch.from_numpy(x)) * bad
        opt.backward(loss)
        return loss

    def jclosure():
        calls["jax"] += 1
        jopt.zero_grad()
        bad = jnp.float32(jnp.inf if calls["jax"] <= 2 else 1.0)
        return jopt.backward(lambda p, x: _jloss(p, x) * bad,
                             jnp.asarray(x))

    loss = opt.step(closure)
    jloss = jopt.step(jclosure)
    assert calls == {"port": 3, "jax": 3}
    assert opt.loss_scale == jopt.loss_scale == 2.0 ** 8
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    _same_params(params, jopt)


def test_fp16_optimizer_state_dict_roundtrip():
    params, opt, jopt = _pair(optimizers.FusedAdam(lr=1e-2),
                              joptim.FusedAdam(lr=1e-2),
                              static_loss_scale=128.0)
    x = _x()
    opt.backward(_loss(params, torch.from_numpy(x)))
    opt.step()
    sd = opt.state_dict()
    assert set(sd) == set(jopt.state_dict())
    twin = _torch_params(_np_params(5))
    opt2 = FP16_Optimizer(optimizers.FusedAdam(lr=1e-2),
                          static_loss_scale=1.0, verbose=False)
    opt2.setup(twin)
    opt2.load_state_dict(sd)
    assert opt2.loss_scale == 128.0
    assert torch.equal(opt2.masters, opt.masters)
    for a, b in zip(params, twin):
        assert torch.equal(a.detach(), b.detach())
    # the next step is bitwise the same
    for o, ps in ((opt, params), (opt2, twin)):
        o.backward(_loss(ps, torch.from_numpy(_x(2))))
        o.step()
    assert torch.equal(opt2.masters, opt.masters)
    assert torch.equal(opt2._inner_state.m, opt._inner_state.m)
    for a, b in zip(params, twin):
        assert torch.equal(a.detach(), b.detach())


def test_fused_weight_norm_export():
    rs = np.random.RandomState(0)
    v = torch.from_numpy(rs.randn(4, 3).astype(np.float32))
    g = torch.from_numpy(rs.rand(4, 1).astype(np.float32))
    w = Fused_Weight_Norm.apply(v, g, 0)
    np.testing.assert_allclose(w.norm(dim=1, keepdim=True).numpy(),
                               g.numpy(), rtol=1e-6)
