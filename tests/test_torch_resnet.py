"""The slice as a whole: ResNet under amp + FusedAdam, the port against the
JAX package on the CPU.

Both models are built from the same numpy weights (the JAX package's
``init``, carried over by ``utils.jax_interop``) and train on the same
numpy batch.  On the CPU the port's kernel wrappers run their plain
PyTorch versions and the JAX package its jnp paths.  Convolutions run
through oneDNN in the port and through XLA in JAX, so the sums round in
other orders: each tolerance says how far that goes.
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
from apex_tpu.nn import functional as JF

from apex_tpu_torch import amp, models, optimizers
from apex_tpu_torch.nn.functional import cross_entropy
from apex_tpu_torch.utils.jax_interop import params_from_jax, params_to_jax

# small enough that three Adam steps do not yet overfit the four images: in
# that regime a loss near zero magnifies every rounding difference
LR = 1e-5
STEPS = 3


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    return {'.'.join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _small_jax():
    return jmodels.ResNet(jmodels.resnet.Bottleneck, [1, 1, 1, 1],
                          num_classes=10)


def _small_port(weights):
    model = models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                          device="cpu")
    model.load_state_dict(params_from_jax(*weights), strict=True)
    return model


@pytest.fixture(scope="module")
def weights():
    params, state = _small_jax().init(jax.random.PRNGKey(0))
    return _numpy_tree(params), _numpy_tree(state)


@pytest.fixture(scope="module")
def resnet50_init():
    """The tree, shapes and dtypes of ``resnet50().init(PRNGKey(0))``,
    with values from numpy: the mapping depends only on the former, and
    this skips compiling 161 random draws."""
    shapes = jax.eval_shape(jmodels.resnet50().init, jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda l: (rs.standard_normal(l.shape) * 100).astype(l.dtype),
        shapes)


def _batch(seed=0, n=4, hw=32):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3, hw, hw).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int32))


# -- weights carried across ---------------------------------------------------------

@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_resnet50_weights_round_trip_bitwise(opt_level, resnet50_init):
    jmodel, _ = jamp.initialize(jmodels.resnet50(), joptim.FusedAdam(),
                                opt_level=opt_level, verbosity=0)
    params, state = resnet50_init
    params = _numpy_tree(jmodel.cast_params(params))
    state = _numpy_tree(state)
    sd = params_from_jax(params, state)

    port, _ = amp.initialize(models.resnet50(device="cpu"),
                             optimizers.FusedAdam(), opt_level=opt_level,
                             verbosity=0)
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, t in want.items():
        assert sd[k].shape == t.shape and sd[k].dtype == t.dtype, k
    # BN in fp32, everything else in the opt level's dtype
    half = torch.bfloat16 if opt_level == "O2" else torch.float32
    assert sd["layer1.0.bn1.weight"].dtype == torch.float32
    assert sd["layer1.0.downsample.0.weight"].dtype == half
    assert sd["layer1.0.bn1.num_batches_tracked"].dtype == torch.int32

    back_params, back_state = params_to_jax(sd)
    assert jax.tree_util.tree_structure(back_params) == \
        jax.tree_util.tree_structure(params)
    assert back_state.keys() == state.keys()
    for a, b in zip(jax.tree_util.tree_leaves((back_params, back_state)),
                    jax.tree_util.tree_leaves((params, state))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- one forward, fp32 --------------------------------------------------------------

def test_forward_and_batch_norm_state_match_jax(weights):
    x, _ = _batch()
    jm = _small_jax()
    apply = jax.jit(lambda p, s, x, train: jnn.apply(jm, p, x, state=s,
                                                     train=train),
                    static_argnums=3)
    out, new_state = apply(weights[0], weights[1], x, True)
    port = _small_port(weights)
    tout = port(torch.from_numpy(x))
    # fp32 convolutions summed in other orders by oneDNN and by XLA's fused
    # CPU code (measured up to 2.7e-5 on logits of size ~1)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=1e-4, atol=5e-5)
    sd = port.state_dict()
    for path, leaves in new_state.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(sd[f"{path}.{k}"].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-6)
    port.eval()
    jout, _ = apply(weights[0], new_state, x, False)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jout), rtol=1e-4, atol=5e-5)


# -- the training slice ----------------------------------------------------------------

def _train_jax(weights, opt_level, x, y):
    jmodel, jopt = jamp.initialize(_small_jax(), joptim.FusedAdam(lr=LR),
                                   opt_level=opt_level, verbosity=0)
    params = jmodel.cast_params(jax.tree_util.tree_map(jnp.asarray,
                                                       weights[0]))
    state = jax.tree_util.tree_map(jnp.asarray, weights[1])
    ost = jopt.init(params)

    @jax.jit
    def step(params, state, ost):
        def loss_fn(p):
            out, new_state = jmodel.apply(p, x, state=state, train=True)
            return JF.cross_entropy(out, y), new_state
        loss, new_state, grads = jamp.scaled_grad(loss_fn, params, ost,
                                                  has_aux=True)
        params, ost, _ = jopt.step(params, ost, grads)
        return params, new_state, ost, loss

    losses = []
    for _ in range(STEPS):
        params, state, ost, loss = step(params, state, ost)
        losses.append(float(loss))
    return losses, params, state, ost


def _train_port(weights, opt_level, x, y):
    model, opt = amp.initialize(_small_port(weights),
                                optimizers.FusedAdam(lr=LR),
                                opt_level=opt_level, verbosity=0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(STEPS):
        loss = cross_entropy(model(xt), yt)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    return losses, model, opt


# loss rtol: O0 is fp32 on both sides, so only the order of the sums
# differs (measured 1.1e-5).  At O2 the convolutions run in bf16, through
# oneDNN here and XLA there: the grads of either side lie ~33% (relative
# norm) from the fp32 grads and ~24-48% from each other, and the losses
# drift apart by up to 8.8e-3 over three steps.
# masters: FusedAdam moves a weight by about lr per step whatever the size
# of its grad, so a near-zero grad whose sign flips under another sum order
# costs up to 2*lr per step.
# BN running stats, as the largest relative norm error of any running
# mean or var: they come from weights that already differ by those sign
# flips (measured 5.9e-6 at O0), and at O2 from bf16 activations, each
# rounded to 2**-8 of its size on its own side (measured 2.3e-2).
@pytest.mark.parametrize("opt_level,loss_rtol,stats_rtol",
                         [("O0", 1e-4, 1e-4), ("O2", 2e-2, 5e-2)])
def test_training_slice_matches_jax(opt_level, loss_rtol, stats_rtol,
                                    weights):
    x, y = _batch(seed=1)
    jl, jparams, jstate, jost = _train_jax(weights, opt_level,
                                           jnp.asarray(x), jnp.asarray(y))
    tl, model, opt = _train_port(weights, opt_level, x, y)

    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)

    if opt_level == "O2":
        # fp32 masters in one flat buffer, in the same layout on both sides
        tm, jm = opt.masters.buf.numpy(), np.asarray(jost.masters.buf)
    else:
        # no masters at O0: the model's fp32 params are what Adam updates
        jp = _paths(jparams)
        tm = np.concatenate([p.detach().numpy().ravel()
                             for n, p in model.named_parameters()])
        jm = np.concatenate([np.asarray(jp[n]).ravel()
                             for n, _ in model.named_parameters()])
    # plus the fp32 rounding of the largest masters (the BN weights near 1)
    atol = 2 * LR * STEPS + 4 * float(np.spacing(np.abs(jm).max()))
    np.testing.assert_allclose(tm, jm, rtol=0, atol=atol)
    assert int(opt.state.step) == int(jost.inner.step) == STEPS

    sd = model.state_dict()
    worst = 0.0
    for path, leaves in jstate.items():
        assert int(sd[f"{path}.num_batches_tracked"]) == STEPS
        for k in ("running_mean", "running_var"):
            t, j = sd[f"{path}.{k}"].numpy(), np.asarray(leaves[k])
            worst = max(worst, np.linalg.norm(t - j) / np.linalg.norm(j))
    assert worst <= stats_rtol, worst
