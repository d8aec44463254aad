"""The port's DCGAN (``apex_tpu_torch.models.dcgan`` and
examples/dcgan/main_amp_torch.py) against the JAX package's, on the CPU.

The models in train and eval mode on the JAX weights
(``utils.jax_interop.dcgan_from_jax``, BatchNorm state included): outputs
within atol and rtol 1e-4 and the new BatchNorm state within rtol 1e-4
(fp32 through five convolutions, the two packages' sums in other orders,
and four batch normalizations over batches of 4, which divide the
rounding by small standard deviations: 5e-5 measured).  Then three
iterations of the example's step at ngf = ndf = 16, batch 4, O0, from the
JAX weights and the JAX example's data draws, against the same step
written with the JAX package's public API here (the JAX example's
``train_step``): the losses within rtol 1e-4, the BatchNorm running
statistics within rtol 1e-4 and their counts exactly (a forward that
updates statistics the JAX step drops, or misses one it keeps, moves the
running means by a tenth of a batch mean), and the parameters within 5 %
of their move from the start in norm (Adam's first steps move a weight by
about lr in the sign of its grad, which a grad near zero need not share
across the two packages' summation orders).  Last, the example as a user
runs it (O1, its default) with ``--device cpu``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import optimizers as joptim
from apex_tpu.nn import functional as JF

from apex_tpu_torch import amp, models
from apex_tpu_torch.utils.jax_interop import dcgan_from_jax, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NZ, NGF, NDF, B = 100, 16, 16, 4
STEPS = 3


def _load_example():
    spec = importlib.util.spec_from_file_location(
        "dcgan_main_amp_torch",
        os.path.join(REPO, "examples", "dcgan", "main_amp_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


example = _load_example()


@pytest.fixture(autouse=True)
def _no_policy():
    yield
    amp.set_policy(amp.NoPolicy())
    jamp.set_policy(jamp.NoPolicy())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_models(seed=0):
    netG, netD = jmodels.dcgan(nz=NZ, ngf=NGF, ndf=NDF)
    kG, kD, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    return netG, netD, netG.init(kG), netD.init(kD)


_dcgan = models.dcgan


def _port_models(jG, jD):
    g, d = _dcgan(nz=NZ, ngf=NGF, ndf=NDF,
                  generator=torch.Generator().manual_seed(0))
    g.load_state_dict(dcgan_from_jax(*map(_np, jG)))
    d.load_state_dict(dcgan_from_jax(*map(_np, jD)))
    return g, d


def _state_close(model, jstate):
    for path, leaves in jstate.items():
        for k, v in leaves.items():
            got = model.get_buffer(f"{path}.{k}")
            if k == "num_batches_tracked":
                assert int(got) == int(v), (path, int(got), int(v))
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(v),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{path}.{k}")


@pytest.mark.parametrize("train", [True, False])
def test_models_against_jax(train):
    netG, netD, jG, jD = _jax_models()
    g, d = _port_models(jG, jD)
    g.train(train)
    d.train(train)
    rs = np.random.RandomState(1)
    z = rs.randn(B, NZ, 1, 1).astype(np.float32)
    fake, sG = netG.apply(jG[0], jnp.asarray(z), state=jG[1], train=train)
    logit, sD = netD.apply(jD[0], fake, state=jD[1], train=train)
    with torch.no_grad():
        out = g(torch.from_numpy(z))
        lo = d(out)
    assert out.shape == (B, 3, 64, 64) and lo.shape == (B,)
    np.testing.assert_allclose(out.numpy(), np.asarray(fake), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lo.numpy(), np.asarray(logit), rtol=1e-4,
                               atol=1e-4)
    _state_close(g, sG)
    _state_close(d, sD)


def _jax_run(args):
    """The JAX example's three iterations, its step as it writes it."""
    netG, netD, jG, jD = _jax_models(args.seed)
    optG = joptim.FusedAdam(lr=args.lr, betas=(args.beta1, 0.999))
    optD = joptim.FusedAdam(lr=args.lr, betas=(args.beta1, 0.999))
    (netD, netG), (optD, optG) = jamp.initialize(
        [netD, netG], [optD, optG], opt_level=args.opt_level, verbosity=0)
    (paramsG, stateG), (paramsD, stateD) = jG, jD
    carry = (paramsD, paramsG, stateD, stateG, optD.init(paramsD),
             optG.init(paramsG))

    def train_step(carry, real, z):
        paramsD, paramsG, stateD, stateG, optD_state, optG_state = carry
        fake = netG.apply(paramsG, z, state=stateG, train=True)[0]

        def d_loss(pD):
            logit_real, sD = netD.apply(pD, real, state=stateD, train=True)
            logit_fake, sD2 = netD.apply(pD, jax.lax.stop_gradient(fake),
                                         state=sD, train=True)
            loss = JF.binary_cross_entropy_with_logits(
                logit_real, jnp.ones_like(logit_real)) + \
                JF.binary_cross_entropy_with_logits(
                    logit_fake, jnp.zeros_like(logit_fake))
            return loss, sD2

        lossD, new_stateD, gD = jamp.scaled_grad(d_loss, paramsD, optD_state,
                                                 has_aux=True)
        paramsD, optD_state, _ = optD.step(paramsD, optD_state, gD)

        def g_loss(pG):
            fake, sG = netG.apply(pG, z, state=stateG, train=True)
            logit, _ = netD.apply(paramsD, fake, state=new_stateD,
                                  train=True)
            return JF.binary_cross_entropy_with_logits(
                logit, jnp.ones_like(logit)), sG

        lossG, new_stateG, gG = jamp.scaled_grad(g_loss, paramsG, optG_state,
                                                 has_aux=True)
        paramsG, optG_state, _ = optG.step(paramsG, optG_state, gG)
        return (paramsD, paramsG, new_stateD, new_stateG, optD_state,
                optG_state), (lossD, lossG)

    step = jax.jit(train_step)
    rng = np.random.RandomState(args.seed)
    losses = []
    for _ in range(args.iters):
        real = jnp.asarray(rng.randn(args.batch_size, 3, 64, 64),
                           jnp.float32)
        z = jnp.asarray(rng.randn(args.batch_size, args.nz, 1, 1),
                        jnp.float32)
        carry, (ld, lg) = step(carry, real, z)
        losses.append((float(ld), float(lg)))
    return np.array(losses), carry, (jG, jD)


def test_example_steps_against_jax(monkeypatch, capsys):
    argv = ["--device", "cpu", "--opt-level", "O0", "-b", str(B), "--iters",
            str(STEPS), "--ngf", str(NGF), "--ndf", str(NDF),
            "--print-freq", "1"]
    jlosses, carry, (jG, jD) = _jax_run(example.parse_args(argv))

    def dcgan(**kw):
        return _port_models(jG, jD)

    monkeypatch.setattr(models, "dcgan", dcgan)
    run = example.main(argv)
    out = capsys.readouterr().out
    assert "done" in out and "[   2/3]" in out, out
    np.testing.assert_allclose(run["losses"].numpy(), jlosses, rtol=1e-4)
    paramsD, paramsG, stateD, stateG, _, _ = carry
    # the update counts: G once an iteration, D twice
    assert int(run["netG"].main[1].num_batches_tracked) == STEPS
    assert int(run["netD"].main[3].num_batches_tracked) == 2 * STEPS
    _state_close(run["netG"], stateG)
    _state_close(run["netD"], stateD)
    for net, p1, p0 in ((run["netG"], paramsG, jG[0]),
                        (run["netD"], paramsD, jD[0])):
        want, start = params_from_jax(_np(p1)), params_from_jax(_np(p0))
        for name, prm in net.named_parameters():
            gap = float((prm.detach() - want[name]).norm())
            move = float((want[name] - start[name]).norm())
            assert move > 0 and gap <= 0.05 * move, (name, gap, move)


def test_example_as_a_user_runs_it(capsys):
    """The default opt level (O1, bf16 casts) on the CPU: finite losses,
    the policy gone afterwards."""
    run = example.main(["--device", "cpu", "-b", "4", "--iters", "2",
                        "--ngf", "8", "--ndf", "8", "--print-freq", "1"])
    out = capsys.readouterr().out
    assert "done" in out and "loss_D" in out
    assert torch.all(torch.isfinite(run["losses"]))
    assert run["optD"].masters.half is None      # O1: fp32 params
    assert isinstance(amp.current_policy(), amp.NoPolicy)
