"""Several models, optimizers and losses under amp, the port against the
JAX package on the CPU.

The cases of ``tests/test_multiple_models.py`` (the reference's
tests/L0/run_amp/test_multiple_models_optimizers_losses.py), run on both
packages from the same weights and batches: two models and two FusedAdams
passed to ``amp.initialize`` as lists; an inf planted at iteration 0 or 1
in model 0 or 1 halves only that model's scaler and skips only its step;
two losses on one optimizer keep independent scalers; and the port's
``amp.state_dict`` equals the JAX package's after the same trajectory.
Loss scales and skip counts must agree exactly; each model's update (its
params less the start) within 1e-2 of the JAX package's, in norm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import nn as jnn
from apex_tpu import optimizers as joptim
from apex_tpu.amp import policy as JP
from apex_tpu.nn import functional as JF

from apex_tpu_torch import amp, nn, optimizers
from apex_tpu_torch.amp import policy as P
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.utils.jax_interop import params_from_jax

X = np.random.RandomState(0).randn(16, 6).astype(np.float32)
Y = np.random.RandomState(1).randn(16, 3).astype(np.float32)
LR = 1e-2
# the fp16 params' rounding (measured: at most 1.8e-3); a missing update
# gives 1, one of the wrong sign 2
UPDATE_GAP = 1e-2


@pytest.fixture(autouse=True)
def reset_policy():
    yield
    P.set_policy(P.NoPolicy())
    JP.set_policy(JP.NoPolicy())


def _jax_models():
    return [jnn.Sequential([jnn.Linear(6, 8), jnn.ReLU(), jnn.Linear(8, 3)]),
            jnn.Sequential([jnn.Linear(6, 8), jnn.Tanh(), jnn.Linear(8, 3)])]


def _weights():
    """fp32 weights of both models from the JAX init, as numpy trees."""
    return [jax.tree_util.tree_map(np.asarray,
                                   m.init(jax.random.PRNGKey(i))[0])
            for i, m in enumerate(_jax_models())]


def _port_models(weights):
    out = []
    for act, w in zip((torch.nn.ReLU, torch.nn.Tanh), weights):
        g = torch.Generator().manual_seed(0)
        m = torch.nn.Sequential(nn.Linear(6, 8, device="cpu", generator=g),
                                act(),
                                nn.Linear(8, 3, device="cpu", generator=g))
        m.load_state_dict(params_from_jax(w), strict=True)
        out.append(m)
    return out


def _jax_loss(model, k, bad):
    def loss_fn(p):
        out, _ = model.apply(p, jnp.asarray(X))
        loss = JF.mse_loss(out.astype(jnp.float32), jnp.asarray(Y))
        return loss * jnp.float32(np.inf) if bad else loss
    return loss_fn


def _port_loss(model, bad):
    loss = F.mse_loss(model(torch.from_numpy(X)).float(),
                      torch.from_numpy(Y))
    return loss * float("inf") if bad else loss


def _run(opt_level, iters=3, inf_at=None, target=0, **kw):
    """Both packages: two models, two FusedAdams, ``iters`` iterations of
    a step each, an inf planted in model ``target``'s loss at iteration
    ``inf_at``.  Returns (port models, port opts, JAX params, JAX states)."""
    weights = _weights()
    kw = dict(opt_level=opt_level, verbosity=0, hard_override=True, **kw)
    jmodels, jopts = jamp.initialize(
        _jax_models(), [joptim.FusedAdam(lr=LR) for _ in range(2)], **kw)
    tmodels, topts = amp.initialize(
        _port_models(weights), [optimizers.FusedAdam(lr=LR)
                                for _ in range(2)], **kw)
    assert isinstance(tmodels, list) and isinstance(topts, list)
    ps = [jm.cast_params(jax.tree_util.tree_map(jnp.asarray, w))
          for jm, w in zip(jmodels, weights)]
    oss = [o.init(p) for o, p in zip(jopts, ps)]
    for it in range(iters):
        for k in range(2):
            bad = it == inf_at and k == target
            _, grads = jamp.scaled_grad(_jax_loss(jmodels[k], k, bad),
                                        ps[k], oss[k])
            ps[k], oss[k], _ = jopts[k].step(ps[k], oss[k], grads)
            with amp.scale_loss(_port_loss(tmodels[k], bad),
                                topts[k]) as scaled:
                scaled.backward()
            topts[k].step()
            topts[k].zero_grad()
    return tmodels, topts, ps, oss


def _assert_models_match(tmodel, jparams, start):
    """The port's update (its params less ``start``, the JAX weights both
    began from) against the JAX package's, in norm over all params."""
    jflat = {k: v.float().numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}
    sflat = params_from_jax(start)
    d_port, d_ref = [], []
    for n, p in tmodel.named_parameters():
        s0 = sflat[n].double().numpy()
        d_port.append(p.detach().double().numpy().ravel() - s0.ravel())
        d_ref.append(jflat[n].astype(np.float64).ravel() - s0.ravel())
    d_port, d_ref = np.concatenate(d_port), np.concatenate(d_ref)
    gap = np.linalg.norm(d_port - d_ref) / np.linalg.norm(d_ref)
    assert gap <= UPDATE_GAP, gap


# tier-1 budget: the JAX test is slow-marked, and so is this one
@pytest.mark.slow
@pytest.mark.parametrize("opt_level", ["O1", "O2", "O3"])
def test_half_tracks_fp32_reference(opt_level):
    def losses(level):
        tm, to, _, _ = _run(level, iters=6)
        return [float(_port_loss(m, False)) for m in tm]
    np.testing.assert_allclose(losses(opt_level), losses("O0"), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("inf_iter", [0, 1])
@pytest.mark.parametrize("target", [0, 1])
def test_inf_skips_only_target_optimizer(inf_iter, target):
    """A planted inf halves only the target's scaler, in both packages
    alike, skips only the target's step, and leaves the other model
    bitwise as in a clean run."""
    kw = dict(half_dtype="float16", loss_scale="dynamic")
    tm_inf, to_inf, jp_inf, jo_inf = _run("O2", inf_at=inf_iter,
                                          target=target, **kw)
    tm_ref, to_ref, jp_ref, jo_ref = _run("O2", **kw)
    s_ref = float(jo_ref[0].scalers[0].loss_scale)
    for k in range(2):
        want = s_ref / 2 if k == target else s_ref
        assert amp.current_loss_scale(to_inf[k]) == want == float(
            jo_inf[k].scalers[0].loss_scale)
        assert amp.steps_skipped(to_inf[k]) == int(k == target) == int(
            jo_inf[k].scalers[0].steps_skipped)
        assert int(to_inf[k].state.step) == int(jo_inf[k].inner.step) == \
            (2 if k == target else 3)
        _assert_models_match(tm_inf[k], jp_inf[k], _weights()[k])
    other = 1 - target
    for (n, a), b in zip(tm_inf[other].named_parameters(),
                         tm_ref[other].parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(to_inf[other].masters.buf, to_ref[other].masters.buf)
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(
        tm_inf[target].parameters(), tm_ref[target].parameters()))
    assert diff > 0
    assert all(torch.isfinite(p).all() for p in tm_inf[target].parameters())


def test_skipped_step_params_unchanged():
    """Iteration 0's inf: the params after the skipped step are the
    initial params, in both packages."""
    w = _weights()[:1]
    kw = dict(opt_level="O2", half_dtype="float16", loss_scale="dynamic",
              verbosity=0, hard_override=True)
    jms, jos = jamp.initialize(_jax_models()[:1],
                               [joptim.FusedAdam(lr=LR)], **kw)
    tms, tos = amp.initialize(_port_models(w), [optimizers.FusedAdam(lr=LR)],
                              **kw)
    params = jms[0].cast_params(jax.tree_util.tree_map(jnp.asarray, w[0]))
    ost = jos[0].init(params)
    _, grads = jamp.scaled_grad(_jax_loss(jms[0], 0, True), params, ost)
    new_params, _, info = jos[0].step(params, ost, grads)
    before = {n: p.detach().clone() for n, p in tms[0].named_parameters()}
    with amp.scale_loss(_port_loss(tms[0], True), tos[0]) as scaled:
        scaled.backward()
    tos[0].step()
    assert float(info["found_inf"]) == float(
        tos[0].last_info["found_inf"]) == 1.0
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(new_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for n, p in tms[0].named_parameters():
        assert torch.equal(p.detach(), before[n]), n


def test_two_losses_one_optimizer_independent_scalers():
    """num_losses=2: each loss_id owns a scaler; an overflow in loss 1
    leaves scaler 0 alone, in both packages."""
    w = _weights()[0]
    kw = dict(opt_level="O2", half_dtype="float16", loss_scale="dynamic",
              num_losses=2, verbosity=0, hard_override=True)
    jm, jo = jamp.initialize(_jax_models()[0], joptim.FusedAdam(lr=LR), **kw)
    tm, to = amp.initialize(_port_models([w])[0], optimizers.FusedAdam(lr=LR),
                            **kw)
    params = jm.cast_params(jax.tree_util.tree_map(jnp.asarray, w))
    ost = jo.init(params)
    assert len(ost.scalers) == len(to.scalers) == 2
    s0 = float(ost.scalers[0].loss_scale)
    _, grads = jamp.scaled_grad(_jax_loss(jm, 0, True), params, ost,
                                loss_id=1)
    params, ost, _ = jo.step(params, ost, grads, loss_id=1)
    with amp.scale_loss(_port_loss(tm, True), to, loss_id=1) as scaled:
        scaled.backward()
    to.step()
    stats = amp.amp_stats(to)
    assert [p["loss_scale"] for p in stats["per_loss"]] == \
        [float(s.loss_scale) for s in ost.scalers] == [s0, s0 / 2]
    assert stats["steps_skipped"] == 1 and stats["num_losses"] == 2


@pytest.mark.parametrize("opt_level,half", [("O2", "float16"),
                                            ("O1", "float16")])
def test_amp_state_dict_matches_jax_after_a_trajectory(opt_level, half):
    """The port's ``amp.state_dict`` over the list of optimizers equals
    the JAX package's ``amp.state_dict`` of each state, after three
    iterations with an overflow in model 1 at iteration 1."""
    _, topts, _, oss = _run(opt_level, inf_at=1, target=1, half_dtype=half,
                            loss_scale="dynamic")
    tsd = amp.state_dict(topts)
    jsd = [jamp.state_dict(o) for o in oss]
    assert len(tsd) == len(jsd) == 2
    for t, j in zip(tsd, jsd):
        assert len(t["scalers"]) == len(j["scalers"]) == 1
        for ts, js in zip(t["scalers"], j["scalers"]):
            assert set(ts) == set(js)
            for k in ts:
                assert ts[k].numpy().tobytes() == np.asarray(
                    js[k]).tobytes(), k
