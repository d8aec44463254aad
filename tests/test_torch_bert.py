"""The slice as a whole: BERT pretraining under amp + FusedAdam, the port
against the JAX package on the CPU.

A tiny ``BertForPretraining`` (vocab 128, hidden 64, 2 layers, 4 heads,
intermediate 128, T = 32, dropout 0) is built from the JAX package's
``init`` and carried over by ``utils.jax_interop``; both sides see the same
numpy batch.  The JAX side runs its Pallas kernels in interpret mode
(``APEX_TPU_FORCE_PALLAS=1``: LayerNorm, flash attention, Adam and the
multi-tensor kernels), the port its wrappers' plain versions.  The JAX
runs are made once per file (module fixture), each step ``jax.jit``-ed so
it compiles once.
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
from apex_tpu.transformer import attention as jattn

from apex_tpu_torch import amp, models, optimizers, transformer
from apex_tpu_torch.utils.jax_interop import (lamb_state_to_jax,
                                              params_from_jax, params_to_jax)

LR = 1e-4                  # BERT's FusedAdam learning rate
STEPS = 3
B, T = 4, 32
CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0, head_chunk=48)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    return {'.'.join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(seed=0):
    """The synthetic MLM/NSP batch of examples/bert/main_amp.py: 15 % of
    the positions are labelled, 80 % of those masked to id 3; the last 5
    positions of two sequences are padding."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, CFG["vocab_size"], (B, T))
    mask = rs.rand(B, T) < 0.15
    labels = np.where(mask, ids, -100)
    ids = np.where(mask & (rs.rand(B, T) < 0.8), 3, ids)
    nsp = rs.randint(0, 2, (B,))
    attn = np.ones((B, T), np.int32)
    attn[1:3, -5:] = 0
    return (ids.astype(np.int32), labels.astype(np.int32),
            nsp.astype(np.int32), attn)


def _port(weights, head_chunk=48):
    cfg = models.BertConfig(**dict(CFG, head_chunk=head_chunk))
    model = models.BertForPretraining(cfg, device="cpu")
    model.load_state_dict(params_from_jax(weights), strict=True)
    return model


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def weights():
    params, state = jmodels.BertForPretraining(
        jmodels.BertConfig(**CFG)).init(jax.random.PRNGKey(0))
    assert not state
    return _numpy_tree(params)


# -- weights carried across ---------------------------------------------------

@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_bert_weights_round_trip_bitwise(opt_level, weights):
    jmodel, _ = jamp.initialize(jmodels.BertForPretraining(
        jmodels.BertConfig(**CFG)), joptim.FusedAdam(), opt_level=opt_level,
        verbosity=0)
    params = _numpy_tree(jmodel.cast_params(weights))
    sd = params_from_jax(params)
    port, _ = amp.initialize(_port(weights), optimizers.FusedAdam(),
                             opt_level=opt_level, verbosity=0)
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, t in want.items():
        assert sd[k].shape == t.shape and sd[k].dtype == t.dtype, k
    # LayerNorm in fp32, everything else in the opt level's dtype
    half = torch.bfloat16 if opt_level == "O2" else torch.float32
    assert sd["bert.layer.0.attention_ln.weight"].dtype == torch.float32
    assert sd["bert.layer.0.attention.qkv.weight"].dtype == half
    # the tied decoder is the word-embedding table, registered once
    assert sum(n.endswith("word_embeddings.weight") for n in sd) == 1
    port.load_state_dict(sd, strict=True)
    back, state = params_to_jax(port.state_dict())
    assert not state
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- forward and loss, fp32 ---------------------------------------------------

# fp32 on both sides through 2 layers; the sums run in other orders
# (measured: logits within 2.5e-7 of values up to 0.68)
@pytest.mark.parametrize("head_chunk,with_mask", [(48, True), (None, False)])
def test_forward_and_loss_match_jax(monkeypatch, weights, head_chunk,
                                    with_mask):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    ids, labels, nsp, attn = _batch()
    attn = attn if with_mask else None
    jm = jmodels.BertForPretraining(
        jmodels.BertConfig(**dict(CFG, head_chunk=head_chunk)))
    p = jax.tree_util.tree_map(jnp.asarray, weights)
    paths = {"jax": [], "port": []}
    jattn.set_path_hook(paths["jax"].append)
    transformer.set_path_hook(paths["port"].append)
    try:
        (jl, jn), _ = jax.jit(lambda p, i, a: jnn.apply(
            jm, p, i, attention_mask=a))(p, ids, attn)
        jloss = jax.jit(lambda p, i, lab, n, a: jm.loss(
            p, i, lab, n, attention_mask=a))(p, ids, labels, nsp, attn)
        port = _port(weights, head_chunk)
        tl, tn = port(_t(ids), attention_mask=None if attn is None
                      else _t(attn))
        tloss = port.loss(_t(ids), _t(labels), _t(nsp),
                          attention_mask=None if attn is None else _t(attn))
    finally:
        jattn.set_path_hook(None)
        transformer.set_path_hook(None)
    assert set(paths["jax"]) == set(paths["port"]) == {"flash"}
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(jn),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)


# -- the training slice -------------------------------------------------------

def _train_jax(weights, opt_level, batch, jopt=None):
    ids, labels, nsp, attn = (jnp.asarray(a) for a in batch)
    jmodel, jopt = jamp.initialize(jmodels.BertForPretraining(
        jmodels.BertConfig(**CFG)), jopt or joptim.FusedAdam(lr=LR),
        opt_level=opt_level, verbosity=0)
    params = jmodel.cast_params(jax.tree_util.tree_map(jnp.asarray, weights))
    ost = jopt.init(params)

    @jax.jit
    def step(params, ost):
        def loss_fn(p):
            return jmodel.loss(p, ids, labels, nsp,
                               attention_mask=attn), ()
        loss, _, grads = jamp.scaled_grad(loss_fn, params, ost, has_aux=True)
        params, ost, _ = jopt.step(params, ost, grads)
        return params, ost, loss

    losses = []
    for _ in range(STEPS):
        params, ost, loss = step(params, ost)
        losses.append(float(loss))
    return losses, params, ost


def _train_port(weights, opt_level, batch, opt=None):
    ids, labels, nsp, attn = (_t(a) for a in batch)
    model, opt = amp.initialize(_port(weights),
                                opt or optimizers.FusedAdam(lr=LR),
                                opt_level=opt_level, verbosity=0)
    losses = []
    for _ in range(STEPS):
        loss = model.loss(ids, labels, nsp, attention_mask=attn)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    return losses, model, opt


@pytest.fixture(scope="module")
def jax_runs(weights):
    """Both opt levels' JAX trajectories, under the forced Pallas path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_FORCE_PALLAS", "1")
        mp.delenv("APEX_TPU_DISABLE_PALLAS", raising=False)
        batch = _batch(seed=1)
        return batch, {lvl: _train_jax(weights, lvl, batch)
                       for lvl in ("O0", "O2")}


# losses: O0 is fp32 on both sides, so only the sums' order differs.  At
# O2 the matmuls run in bf16 through oneDNN here and XLA there, and bf16
# activations (LayerNorm outputs, P, dS) round on each side on their own
# (measured: losses within 2.8e-4 relative over three steps, 8.4e-8 at O0).
# masters: FusedAdam moves a weight by about lr a step whatever the size of
# its grad, so a near-zero grad whose sign flips under another sum order
# costs up to 2*lr a step (measured at O2: 5.3e-4 of the 6e-4).
@pytest.mark.parametrize("opt_level,loss_rtol", [("O0", 1e-5), ("O2", 1e-2)])
def test_training_slice_matches_jax(jax_runs, weights, opt_level, loss_rtol):
    batch, runs = jax_runs
    jl, jparams, jost = runs[opt_level]
    tl, model, opt = _train_port(weights, opt_level, batch)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    if opt_level == "O2":
        # fp32 masters in one flat buffer, in the same layout on both sides
        tm, jm = opt.masters.buf.numpy(), np.asarray(jost.masters.buf)
    else:
        jp = _paths(jparams)
        names = [n for n, _ in model.named_parameters()]
        assert set(names) == set(jp)
        tm = np.concatenate([p.detach().numpy().ravel()
                             for _, p in model.named_parameters()])
        jm = np.concatenate([np.asarray(jp[n]).ravel() for n in names])
    atol = 2 * LR * STEPS + 4 * float(np.spacing(np.abs(jm).max()))
    np.testing.assert_allclose(tm, jm, rtol=0, atol=atol)
    assert int(opt.state.step) == int(jost.inner.step) == STEPS


# -- the BERT-large slice's optimizer: FusedLAMB ------------------------------

LAMB_LR = 1e-3             # BERT-large's FusedLAMB learning rate


@pytest.fixture(scope="module")
def jax_lamb_runs(weights):
    """Both opt levels' JAX trajectories with FusedLAMB, under the forced
    Pallas path (the LAMB kernels in interpret mode)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_FORCE_PALLAS", "1")
        mp.delenv("APEX_TPU_DISABLE_PALLAS", raising=False)
        batch = _batch(seed=2)
        return batch, {lvl: _train_jax(weights, lvl, batch,
                                       joptim.FusedLAMB(lr=LAMB_LR))
                       for lvl in ("O0", "O2")}


def _jax_masters(jparams, jost, opt_level):
    """The JAX package's fp32 masters in the port's flat order: under O2
    the master tree it keeps for a non-elementwise optimizer, under O0 the
    params."""
    tree = jost.masters if opt_level == "O2" else jparams
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


# O0 is fp32 on both sides, only the sums' order differs (measured: losses
# within 8.6e-8 relative, masters within 1.8e-7, m and v within 3e-7 in
# relative norm).  At O2 the bf16 matmuls round apart (losses within 1.1e-4;
# m and v 7.2e-3 in relative norm), and LAMB moves each element by
# lr*ratio*u, ratio = ||p||/||u|| and u within a few units of 1, so a
# near-zero grad whose sign flips costs about 2*lr*|p| a step: masters
# within 2*lr*steps*max|p| (measured 3.5e-3 of 6.0e-3)
@pytest.mark.parametrize("opt_level,loss_rtol,masters_atol,moments_rel", [
    ("O0", 1e-6, 1e-6, 1e-5), ("O2", 1e-3, None, 3e-2)])
def test_training_slice_lamb_matches_jax(jax_lamb_runs, weights, opt_level,
                                         loss_rtol, masters_atol,
                                         moments_rel):
    batch, runs = jax_lamb_runs
    jl, jparams, jost = runs[opt_level]
    tl, model, opt = _train_port(weights, opt_level, batch,
                                 optimizers.FusedLAMB(lr=LAMB_LR))
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    tm, jm = opt.masters.buf.numpy(), _jax_masters(jparams, jost, opt_level)
    atol = masters_atol or 2 * LAMB_LR * STEPS * float(np.abs(jm).max())
    np.testing.assert_allclose(tm, jm, rtol=0, atol=atol)
    # the moments, padded as the JAX package lays them out
    back = lamb_state_to_jax(opt.state)
    jinner = jost.inner
    for k in ("m", "v"):
        want = np.asarray(getattr(jinner, k).buf)
        rel = np.linalg.norm(back[k] - want) / np.linalg.norm(want)
        assert rel < moments_rel, (k, rel)
    assert int(opt.state.step) == int(jinner.step) == STEPS


def test_tp_and_sp_raise_naming_the_roadmap():
    for kw in (dict(tp_axis="model"), dict(sp_axis="sp")):
        with pytest.raises(NotImplementedError, match="item 6"):
            models.BertConfig(**kw)


def test_dropout_on_in_train_mode_only():
    """With the config's dropout 0.1 the train-mode loss depends on the
    dropout generator and the eval-mode loss does not."""
    ids, labels, nsp, attn = (_t(a) for a in _batch())
    cfg = models.BertConfig(**dict(CFG, hidden_dropout_prob=0.1,
                                   attention_probs_dropout_prob=0.1))

    def loss(train, seed):
        m = models.BertForPretraining(
            cfg, device="cpu",
            dropout_generator=torch.Generator().manual_seed(seed))
        m.train(train)
        with torch.no_grad():
            return float(m.loss(ids, labels, nsp, attention_mask=attn))

    assert loss(False, 0) == loss(False, 1)
    assert loss(True, 0) != loss(True, 1)
    assert loss(True, 0) == loss(True, 0)
