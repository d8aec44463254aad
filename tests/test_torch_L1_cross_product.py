"""The L1 tier of the port, on the CPU.

tests/test_L1_cross_product.py trains a small conv net under a slice of
the reference's config cross product (tests/L1/common/run_test.sh:64-135)
with the JAX package's Pallas kernels and with its jnp fallback.  Here
the same net, from the same weights (the JAX ``init``, carried over by
``utils.jax_interop``) and the same numpy batch, trains under each of
those 10 Adam and 2 LAMB configs in the port on the CPU (the kernels'
plain versions) and in the JAX package's jnp side
(``APEX_TPU_DISABLE_PALLAS=1``, set and restored as that file does).
Tolerances, set from what each config's dtype allows:

- O0 (fp32 throughout): loss trajectories within 1e-6 of max(1, |loss|)
  (measured 1.2e-7: the jnp optimizers divide where the port, like the
  kernels, multiplies by the reciprocal);
- O1-O3 (bf16 convolutions and matmuls): within 1e-2 (measured 1.2e-3:
  XLA and oneDNN round bf16 products at other places, and the steps of lr
  1e-2 carry the difference on); every config must still make progress.

The full matrix (``tests/L1/run_l1_torch.py``) runs on the card; here its
runner, ``torch_l1_common.train_one``, runs twice on the CPU at a small
size and must give the same bits.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import nn as jnn
from apex_tpu import optimizers as joptim
from apex_tpu.nn import functional as JF

from apex_tpu_torch import amp, nn, optimizers
from apex_tpu_torch.nn.functional import cross_entropy
from apex_tpu_torch.utils.jax_interop import params_from_jax

from tests.L1.torch_l1_common import train_one

ITERS = 8
BATCH = 8
LR = 1e-2


@pytest.fixture(autouse=True)
def _no_policy():
    """O1 installs a process-wide cast policy in both packages."""
    yield
    amp.set_policy(amp.NoPolicy())
    jamp.policy.set_policy(jamp.policy.NoPolicy())


@contextlib.contextmanager
def _jnp_side():
    """The JAX package's jnp fallback, restoring the ambient toggles."""
    old = {k: os.environ.pop(k, None)
           for k in ("APEX_TPU_FORCE_PALLAS", "APEX_TPU_DISABLE_PALLAS")}
    os.environ["APEX_TPU_DISABLE_PALLAS"] = "1"
    try:
        yield
    finally:
        os.environ.pop("APEX_TPU_DISABLE_PALLAS", None)
        for k, v in old.items():
            if v is not None:
                os.environ[k] = v


def _jax_net():
    return jnn.Sequential([
        jnn.Conv2d(3, 8, 3, padding=1), jnn.BatchNorm2d(8), jnn.ReLU(),
        jnn.Flatten(), jnn.Linear(8 * 8 * 8, 4)])


def _port_net():
    gen = torch.Generator().manual_seed(0)
    return torch.nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1, device="cpu", generator=gen),
        nn.BatchNorm2d(8, device="cpu"), nn.ReLU(), nn.Flatten(),
        nn.Linear(8 * 8 * 8, 4, device="cpu", generator=gen))


def _data():
    rs = np.random.RandomState(1)
    return (rs.randn(BATCH, 3, 8, 8).astype(np.float32),
            rs.randint(0, 4, BATCH).astype(np.int32))


@pytest.fixture(scope="module")
def weights():
    params, state = _jax_net().init(jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


def _train_jax(weights, opt_level, loss_scale, keep_bn, opt):
    x, y = (jnp.asarray(a) for a in _data())
    with _jnp_side():
        base = (joptim.FusedLAMB(lr=LR) if opt == "lamb"
                else joptim.FusedAdam(lr=LR))
        model, optimizer = jamp.initialize(
            _jax_net(), base, opt_level=opt_level, loss_scale=loss_scale,
            keep_batchnorm_fp32=keep_bn, verbosity=0, hard_override=True)
        params = model.cast_params(jax.tree_util.tree_map(jnp.asarray,
                                                          weights[0]))
        state = jax.tree_util.tree_map(jnp.asarray, weights[1])
        opt_state = optimizer.init(params)

        def loss_fn(p):
            out, s = model.apply(p, x, state=state, train=True)
            return JF.cross_entropy(out, y), s

        @jax.jit
        def step(params, opt_state):
            loss, _, grads = jamp.scaled_grad(loss_fn, params, opt_state,
                                              has_aux=True)
            params, opt_state, _ = optimizer.step(params, opt_state, grads)
            return params, opt_state, loss

        traj = []
        for _ in range(ITERS):
            params, opt_state, loss = step(params, opt_state)
            traj.append(float(loss))
        return np.asarray(traj)


def _train_port(weights, opt_level, loss_scale, keep_bn, opt):
    x, y = (torch.from_numpy(a) for a in _data())
    net = _port_net()
    net.load_state_dict(params_from_jax(*weights), strict=True)
    base = (optimizers.FusedLAMB(lr=LR) if opt == "lamb"
            else optimizers.FusedAdam(lr=LR))
    model, optimizer = amp.initialize(
        net, base, opt_level=opt_level, loss_scale=loss_scale,
        keep_batchnorm_fp32=keep_bn, verbosity=0, hard_override=True)
    traj = []
    for _ in range(ITERS):
        loss = cross_entropy(model(x), y)
        with amp.scale_loss(loss, optimizer) as scaled:
            scaled.backward()
        optimizer.step()
        traj.append(float(loss.detach()))
    return np.asarray(traj)


# tests/test_L1_cross_product.py's CONFIGS
CONFIGS = (
    [("O0", None, None), ("O1", None, None),
     ("O2", None, None), ("O3", None, None)] +
    [("O2", ls, None) for ls in ("1.0", "128.0", "dynamic")] +
    [("O2", None, kbn) for kbn in ("True", "False")] +
    [("O3", None, "True")]
)


def _hold(port, ref, opt_level):
    assert np.all(np.isfinite(port)), port
    rtol = 1e-6 if opt_level == "O0" else 1e-2
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol)
    assert port[-1] < port[0], port


@pytest.mark.parametrize("opt_level,loss_scale,keep_bn", CONFIGS)
def test_port_matches_jnp_trajectory(weights, opt_level, loss_scale,
                                     keep_bn):
    ref = _train_jax(weights, opt_level, loss_scale, keep_bn, "adam")
    port = _train_port(weights, opt_level, loss_scale, keep_bn, "adam")
    _hold(port, ref, opt_level)


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_lamb_port_matches_jnp_trajectory(weights, opt_level):
    ref = _train_jax(weights, opt_level, None, None, "lamb")
    port = _train_port(weights, opt_level, None, None, "lamb")
    _hold(port, ref, opt_level)


def test_resnet18_train_one_is_bitwise_repeatable_on_cpu():
    """The L1 runner's own discipline at a small size: two runs of the
    same config, the same trajectory and parameter digest."""
    a, da = train_one("O0", None, None, device="cpu", iters=5, batch=2,
                      image=16)
    b, db = train_one("O0", None, None, device="cpu", iters=5, batch=2,
                      image=16)
    assert a.tobytes() == b.tobytes(), np.abs(a - b).max()
    assert da == db
    assert np.all(np.isfinite(a))
