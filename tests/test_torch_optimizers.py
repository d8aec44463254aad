"""The port's other optimizers and helpers against the JAX package, on the
CPU: ``SGD``, ``FusedLion``, ``LARC`` (over SGD and FusedAdam),
``FP16_Optimizer``, ``utils.ema`` and ``nn.LayerNorm`` (as
tests/test_larc_reparam.py, tests/test_lion_ema.py and
tests/test_fused_adam.py hold the JAX ones).

The JAX side updates a dict of tensors; the port updates one flat fp32
buffer laid out in the same (sorted-key) order.  XLA's CPU code contracts
a multiply and an add into one FMA where the port rounds both (as its
CUDA kernels do), so results agree to a few ulps, not bitwise: each
comparison states its tolerance.  Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu import nn as jnn
from apex_tpu import optimizers as joptim
from apex_tpu.parallel import LARC as JLARC
from apex_tpu.utils import ema as jema

from apex_tpu_torch import amp, nn, optimizers, parallel
from apex_tpu_torch.multi_tensor_apply import ChunkedFlatLayout
from apex_tpu_torch.utils import ema

f32 = np.float32
SHAPES = {"a": (7,), "b": (33, 5), "c": (1025,), "z": (4,)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tree(seed, scale=1.0, zero=None):
    rs = np.random.RandomState(seed)
    return {k: (np.zeros(s, f32) if k == zero else
                (rs.randn(*s) * scale).astype(f32))
            for k, s in SHAPES.items()}


def _flat(tree) -> torch.Tensor:
    return torch.cat([_t(tree[k]).reshape(-1) for k in sorted(tree)])


def _jflat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k]).ravel() for k in sorted(tree)])


def _jtree(tree):
    return {k: jnp.asarray(a) for k, a in tree.items()}


# -- SGD ------------------------------------------------------------------------

@pytest.mark.parametrize("momentum,nesterov,wd,dampening", [
    (0.0, False, 0.0, 0.0), (0.9, False, 1e-4, 0.0), (0.9, True, 1e-4, 0.0),
    (0.9, False, 0.0, 0.1)])
def test_sgd_matches_jax(momentum, nesterov, wd, dampening):
    kw = dict(lr=0.1, momentum=momentum, weight_decay=wd, nesterov=nesterov,
              dampening=dampening)
    params = _tree(0)
    jopt, opt = joptim.SGD(**kw), optimizers.SGD(**kw)
    jp = _jtree(params)
    jst = jopt.init(jp)
    flat = _flat(params)
    st = opt.init(flat)
    for i in range(3):
        g = _tree(1 + i)
        jp, jst = jopt.update(_jtree(g), jst, jp)
        opt.step(flat, st, _flat(g))
    assert int(st.step) == int(jst.step) == 3
    # XLA contracts wd*p + g, the momentum update and p - lr*g into FMAs
    np.testing.assert_allclose(flat.numpy(), _jflat(jp), rtol=1e-6,
                               atol=1e-7)
    if momentum:
        np.testing.assert_allclose(st.momentum.numpy(),
                                   _jflat(jst.momentum), rtol=1e-6,
                                   atol=1e-7)
    else:
        assert st.momentum is None and jst.momentum is None


# -- FusedLion ------------------------------------------------------------------

@pytest.mark.parametrize("wd,max_grad_norm,scale", [
    (0.0, 0.0, 1.0), (0.1, 0.0, 128.0), (0.01, 1.0, 4.0)])
def test_lion_matches_jax(wd, max_grad_norm, scale):
    kw = dict(lr=0.01, betas=(0.9, 0.99), weight_decay=wd,
              max_grad_norm=max_grad_norm)
    params = _tree(3)
    jopt, opt = joptim.FusedLion(**kw), optimizers.FusedLion(**kw)
    jp = _jtree(params)
    jst = jopt.init(jp)
    flat = _flat(params)
    st = opt.init(flat)
    half = torch.empty(flat.numel(), dtype=torch.bfloat16)
    for i in range(3):
        g = _tree(4 + i, scale)
        jp, jst, jhalf = jopt.step(jp, jst, _jtree(g), scale=scale,
                                   output_params_dtype=jnp.bfloat16)
        opt.step(flat, st, _flat(g), scale=scale, half=half)
    assert int(st.step) == int(jst.step) == 3
    # sign(.) is exact on both sides; p - lr*(u + wd*p) may be contracted
    np.testing.assert_allclose(flat.numpy(), _jflat(jp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(st.m.numpy(), np.asarray(jst.m), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(half, flat.to(torch.bfloat16))
    d = np.abs(half.float().numpy() - np.asarray(jhalf, np.float32))
    assert d.max() <= 2.0 ** -7 * np.abs(_jflat(jp)).max()


def test_lion_skip_leaves_everything():
    opt = optimizers.FusedLion(lr=0.1)
    flat = _flat(_tree(7))
    st = opt.init(flat)
    opt.step(flat, st, _flat(_tree(8)))
    before = (flat.clone(), st.m.clone(), st.step.clone())
    opt.step(flat, st, _flat(_tree(9)), noop=torch.ones(()))
    for a, b in zip((flat, st.m, st.step), before):
        assert torch.equal(a, b)


# -- LARC -------------------------------------------------------------------------

def _larc_pair(inner, clip):
    if inner == "sgd":
        return (JLARC(joptim.SGD(lr=0.1, momentum=0.9, weight_decay=1e-3),
                      trust_coefficient=0.02, clip=clip),
                parallel.LARC(optimizers.SGD(lr=0.1, momentum=0.9,
                                             weight_decay=1e-3),
                              trust_coefficient=0.02, clip=clip))
    kw = dict(lr=1e-3, weight_decay=0.01)
    return (JLARC(joptim.FusedAdam(**kw), trust_coefficient=0.02, clip=clip),
            parallel.LARC(optimizers.FusedAdam(**kw), trust_coefficient=0.02,
                          clip=clip))


@pytest.mark.parametrize("inner", ["sgd", "adam"])
@pytest.mark.parametrize("clip", [True, False])
def test_larc_matches_jax(monkeypatch, inner, clip):
    # FusedAdam with its kernel's arithmetic on the JAX side too
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    jopt, opt = _larc_pair(inner, clip)
    # the inner weight decay is absorbed into LARC on both sides
    assert jopt.optim.weight_decay == opt.optim.weight_decay == 0.0
    assert jopt.weight_decay == opt.weight_decay > 0
    params = _tree(10)
    jp = _jtree(params)
    jst = jopt.init(jp)
    tensors = [_t(params[k]) for k in sorted(params)]
    lay = ChunkedFlatLayout(tensors)
    flat = lay.pack(tensors)
    st = opt.init(flat, lay)
    for i in range(3):
        # a tensor with zero grads takes the base rate (the zero-norm
        # guard)
        g = _tree(11 + i, zero="z")
        jp, jst = jopt.update(_jtree(g), jst, jp)
        opt.step(flat, st, _flat(g))
    assert int(st.step) == int(jst.step) == 3
    # per-tensor norms summed in other orders, and XLA's FMAs
    np.testing.assert_allclose(flat.numpy(), _jflat(jp), rtol=1e-5,
                               atol=1e-6)
    moments = (("momentum", "momentum"),) if inner == "sgd" else (
        ("m", "m"), ("v", "v"))
    for ours, theirs in moments:
        np.testing.assert_allclose(getattr(st.inner, ours).numpy(),
                                   np.asarray(_jflat_any(getattr(jst,
                                                                 theirs))),
                                   rtol=1e-5, atol=1e-7)


def _jflat_any(x):
    return _jflat(x) if isinstance(x, dict) else np.asarray(x)


def test_larc_under_amp_skips_an_overflowed_step():
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(nn.Linear(6, 5, device="cpu", generator=gen),
                                nn.LayerNorm(5),
                                nn.Linear(5, 2, device="cpu", generator=gen))
    model, opt = amp.initialize(
        model, parallel.LARC(optimizers.FusedAdam(lr=1e-2)),
        opt_level="O2", half_dtype="float16", verbosity=0)
    x = torch.randn(4, 6, generator=gen)
    losses = []
    for _ in range(3):
        loss = model(x).square().mean()
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] and int(opt.state.step) == 3
    before = [t.clone() for t in (opt.masters.buf, opt.masters.half,
                                  opt.state.inner.m, opt.state.inner.v)]
    x[0, 0] = float("inf")
    loss = model(x).square().mean()
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
    opt.step()
    assert float(opt.last_info["found_inf"]) == 1.0
    for a, b in zip((opt.masters.buf, opt.masters.half, opt.state.inner.m,
                     opt.state.inner.v), before):
        assert torch.equal(a, b)
    assert int(opt.state.step) == 3


def test_larc_wraps_elementwise_optimizers_only():
    with pytest.raises(TypeError):
        parallel.LARC(optimizers.FusedLAMB())


# -- FP16_Optimizer -----------------------------------------------------------------

def test_fp16_optimizer_matches_jax(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    params16 = {k: a.astype(np.float16) for k, a in _tree(20).items()}
    kw = dict(dynamic_loss_scale=True)
    jfo = joptim.FP16_Optimizer(joptim.FusedAdam(lr=1e-2), **kw)
    fo = optimizers.FP16_Optimizer(optimizers.FusedAdam(lr=1e-2), **kw)
    jp = _jtree(params16)
    jst = jfo.init(jp)
    params = [_t(params16[k]) for k in sorted(params16)]
    st = fo.init(params)
    assert st.masters.dtype == torch.float32
    scale = float(st.scaler.loss_scale)
    for i, bad in enumerate((False, False, True, False)):
        g = {k: (a * scale / 64).astype(np.float16)
             for k, a in _tree(21 + i).items()}
        if bad:
            g["b"][0, 0] = np.inf
        jp, jst, jinfo = jfo.step(jp, jst, _jtree(g))
        info = fo.step(params, st, [_t(g[k]) for k in sorted(g)])
        assert float(info["found_inf"]) == float(jinfo["found_inf"]) == bad
        np.testing.assert_allclose(float(info["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-5)
        if bad:
            assert float(info["grad_norm"]) == -1.0
        assert float(info["loss_scale"]) == float(jinfo["loss_scale"])
    assert float(st.scaler.loss_scale) == scale / 2
    assert int(st.adam.step) == int(jst.adam.step) == 3
    # fp32 masters: the JAX masters through FusedAdam's kernel arithmetic
    # in interpret mode, whose EMAs XLA contracts into FMAs
    np.testing.assert_allclose(st.masters.numpy(),
                               _jflat(jst.masters), rtol=1e-5, atol=1e-6)
    for k, p in zip(sorted(params16), params):
        assert p.dtype == torch.float16
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(jp[k], np.float32),
                                   rtol=2.0 ** -10, atol=1e-6)


def test_fp16_optimizer_takes_fused_adam_only():
    with pytest.raises(TypeError):
        optimizers.FP16_Optimizer(optimizers.SGD())


# -- ema -------------------------------------------------------------------------

def test_ema_matches_jax():
    jst = jema.init(_jtree(_tree(30)))
    params = [_t(a) for a in _tree(30).values()]
    st = ema.init(params)
    for i in range(4):
        p = _tree(31 + i)
        jst = jema.update(jst, _jtree(p), decay=0.9)
        st = ema.update(st, [_t(a) for a in p.values()], decay=0.9)
    assert int(st.step) == int(jst.step) == 4
    for got, want in zip(ema.value(st, decay=0.9),
                         jema.value(jst, decay=0.9).values()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    # a constant parameter: the debiased average is the constant
    st = ema.init([torch.full((3,), 2.0)])
    for _ in range(5):
        st = ema.update(st, [torch.full((3,), 2.0)], decay=0.9)
    np.testing.assert_allclose(ema.value(st, decay=0.9)[0].numpy(), 2.0,
                               rtol=1e-6)


# -- nn.LayerNorm ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_module_matches_jax(monkeypatch, dtype):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    rs = np.random.RandomState(40)
    x = (rs.randn(6, 10, 48) * 2 + 0.5).astype(f32)
    w, b = rs.randn(48).astype(f32), rs.randn(48).astype(f32)
    jm = jnn.LayerNorm(48, eps=1e-5)
    jy, _ = jnn.apply(jm, {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                      jnp.asarray(x).astype(jnp.bfloat16 if dtype ==
                                            torch.bfloat16 else jnp.float32))
    ln = nn.LayerNorm(48, eps=1e-5)
    assert ln.fp32_params and ln.weight.dtype == torch.float32
    assert [n for n, _ in ln.named_parameters()] == ["weight", "bias"]
    ln.load_state_dict({"weight": _t(w), "bias": _t(b)})
    y = ln(_t(x).to(dtype))
    assert y.dtype == dtype and y.shape == x.shape
    # fp32: the sums in other orders; bf16: one rounding of y either side
    tol = 2e-6 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(jy, np.float32), rtol=tol,
                               atol=tol * 4)
