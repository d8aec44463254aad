"""The port's legacy amp handle API (``amp.init``, ``AmpHandle``,
``NoOpHandle``, ``OptimWrapper``) against the JAX package's, on the CPU:
the seven cases of tests/test_legacy_amp.py.  The model is one Linear(4,
4) on the JAX weights under O2 + FusedAdam(lr 1e-2); where both packages
train, the trained weights agree within atol 1e-2 (bf16 weights, the
Adam step of about lr in the sign of each grad) and the loss scales
exactly.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import nn as jnn
from apex_tpu import optimizers as joptim
from apex_tpu.nn import functional as JF

from apex_tpu_torch import amp, nn, optimizers
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.utils.jax_interop import params_from_jax


@pytest.fixture(autouse=True)
def _no_policy():
    yield
    amp.set_policy(amp.NoPolicy())
    jamp.set_policy(jamp.NoPolicy())


def _setup(**kw):
    jmodel = jnn.Sequential([jnn.Linear(4, 4)])
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    _, jopt = jamp.initialize(jmodel, joptim.FusedAdam(lr=1e-2),
                              opt_level="O2", verbosity=0,
                              hard_override=True, **kw)
    model = torch.nn.Sequential(nn.Linear(4, 4,
                                          generator=torch.Generator()))
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-2),
                                opt_level="O2", verbosity=0,
                                hard_override=True, **kw)
    return (jmodel, jparams, jopt), (model, opt)


def _wrap(handle, opt, params=None, num_loss=1):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        w = handle.wrap_optimizer(opt, num_loss=num_loss)
    if params is not None:
        w.setup(params)
    return w


X, Y = np.ones((3, 4), np.float32), np.zeros((3, 4), np.float32)


def _loss(model):
    return F.mse_loss(model(torch.from_numpy(X)).float(),
                      torch.from_numpy(Y))


def _jloss_fn(jmodel):
    def loss_fn(p):
        out, _ = jmodel.apply(p, jnp.asarray(X))
        return JF.mse_loss(out.astype(jnp.float32), jnp.asarray(Y))
    return loss_fn


def test_handle_activation_lifecycle():
    handle = amp.init(enabled=True)
    assert handle.is_active()
    assert isinstance(amp.current_policy(), amp.CastPolicy)
    handle._deactivate()
    assert not handle.is_active()
    assert isinstance(amp.current_policy(), amp.NoPolicy)
    assert not amp.init(enabled=False).is_active()
    jh = jamp.init(enabled=True)
    assert type(jamp.policy.current_policy()).__name__ == \
        type(amp.policy.CastPolicy(torch.bfloat16)).__name__
    jh._deactivate()


def test_optim_wrapper_deprecation_warning():
    handle = amp.init(enabled=True)
    _, (model, opt) = _setup()
    with pytest.warns(DeprecationWarning):
        handle.wrap_optimizer(opt)
    handle._deactivate()


def test_optim_wrapper_trains():
    handle = amp.init(enabled=True)
    (jmodel, jparams, jopt), (model, opt) = _setup()
    w = _wrap(handle, opt)
    before = model[0].weight.detach().float().clone()
    with w.scale_loss(_loss(model)) as scaled:
        assert float(scaled.detach()) >= 0   # float()-able like the reference's yield
        scaled.backward()
    w.step()
    after = model[0].weight.detach().float()
    assert float((after - before).abs().max()) > 0
    handle._deactivate()
    jh = jamp.init(enabled=True)
    jw = _wrap(jh, jopt, jparams)
    with jw.scale_loss(_jloss_fn(jmodel)) as s:
        s.backward()
    jw.step()
    np.testing.assert_allclose(
        after.numpy(), np.asarray(jw.params["0"]["weight"], np.float32),
        atol=1e-2)
    assert w.loss_scale == float(jw.loss_scale)
    jh._deactivate()


def test_optim_wrapper_num_loss_exceeded_raises():
    handle = amp.init(enabled=True)
    _, (model, opt) = _setup()
    w = _wrap(handle, opt, num_loss=1)
    with w.scale_loss(_loss(model)) as s:
        s.backward()
    with pytest.raises(RuntimeError, match="Unable to scale 2 losses"):
        with w.scale_loss(_loss(model)) as s:
            s.backward()
    with pytest.raises(NotImplementedError, match="closures"):
        w.step(lambda: None)
    handle._deactivate()


def test_optim_wrapper_requires_setup():
    """An optimizer not bound to a model refuses to scale until
    ``setup(model)`` binds it."""
    handle = amp.init(enabled=True)
    opt = amp.AmpOptimizer(optimizers.FusedAdam(lr=1e-2),
                           amp.LossScaler("dynamic"), master_weights=True)
    w = _wrap(handle, opt, num_loss=2)
    model = torch.nn.Sequential(nn.Linear(4, 4, generator=torch.Generator()))
    with pytest.raises(RuntimeError, match="setup"):
        with w.scale_loss(_loss(model)):
            pass
    w.setup(model)
    assert len(opt.scalers) == 2
    with w.scale_loss(_loss(model)) as s:
        s.backward()
    w.step()
    handle._deactivate()


def test_noop_handle_passthrough():
    noop = amp.init(enabled=False)
    assert isinstance(amp.current_policy(), amp.NoPolicy)
    loss = torch.ones(())
    with noop.scale_loss(loss, None) as out:
        assert out is loss
    noop._deactivate()


def test_optim_wrapper_two_losses():
    """num_loss=2 gives two scalers, each loss scaled by its own, the step
    applying both backward passes (fp16, dynamic scales)."""
    (jmodel, jparams, jopt), (model, opt) = _setup(
        half_dtype="float16", loss_scale="dynamic")
    handle = amp.init(enabled=True, half_dtype=torch.float16)
    w = _wrap(handle, opt, num_loss=2)
    assert len(opt.scalers) == 2
    with w.scale_loss(_loss(model)) as s:
        assert float(s.detach()) == float(_loss(model).detach()) * 2.0 ** 16
        s.backward()
    with w.scale_loss(_loss(model) * 0.5) as s:
        s.backward()
    w.step()
    stats = amp.amp_stats(opt)
    assert stats["num_losses"] == 2 and len(w.state_dict()["scalers"]) == 2
    handle._deactivate()
    jh = jamp.init(enabled=True)
    jw = _wrap(jh, jopt, jparams, num_loss=2)
    assert len(jw._bound.opt_state.scalers) == 2
    for k in (1.0, 0.5):
        with jw.scale_loss(lambda p, k=k: _jloss_fn(jmodel)(p) * k) as s:
            s.backward()
    jw.step()
    # each loss's scaler moved as the JAX one's
    assert [d["loss_scale"] for d in stats["per_loss"]] == [
        float(s.loss_scale) for s in jw._bound.opt_state.scalers]
    np.testing.assert_allclose(
        model[0].weight.detach().float().numpy(),
        np.asarray(jw.params["0"]["weight"], np.float32), atol=1e-2)
    jh._deactivate()
