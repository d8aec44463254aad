"""LoRA adapters of the port against the JAX package on the CPU.

A tiny Llama (vocab 97, width 32, 2 layers, 4 heads, 2 KV heads) from the
JAX package's ``init``, carried over by ``utils.jax_interop`` with its
adapters: merging at init is the identity, bitwise; merging nonzero
adapters equals the JAX package's merge at rtol 1e-6; adapter-only
training through ``amp.initialize`` and ``make_step`` learns and leaves
the base bitwise as it was; merged weights generate and quantize; GPT
targets and the errors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import lora as jlora
from apex_tpu import models as jmodels

from apex_tpu_torch import amp, lora, models, optimizers, parallel
from apex_tpu_torch import quantization
from apex_tpu_torch.utils.jax_interop import (adapters_from_jax,
                                              adapters_to_jax,
                                              params_from_jax)

KW = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_position_embeddings=16, tie_word_embeddings=True)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def llama():
    jm = jmodels.Llama(jmodels.LlamaConfig(**KW))
    params, _ = jm.init(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port(params):
    tm = models.Llama(models.LlamaConfig(**KW), device="cpu")
    tm.load_state_dict(params_from_jax(params))
    return tm


class _LossOf(torch.nn.Module):
    """``model.loss`` as a module's forward, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids):
        return self.model.loss(ids)


def _merged_loss(model, adapters, s, ids):
    """The loss on merged weights: the base's own tensors (detached) with
    the adapters' deltas, through ``functional_call``."""
    base = {f"model.{n}": p.detach() for n, p in model.named_parameters()}
    return torch.func.functional_call(
        _LossOf(model), lora.merge(base, {f"model/{k}": v
                                          for k, v in adapters.items()}, s),
        (ids,))


def test_merge_at_init_is_the_identity(llama):
    _, params = llama
    tm = _port(params)
    ad = lora.init(tm, targets=("q_proj", "v_proj"), rank=4,
                   generator=torch.Generator().manual_seed(1))
    assert len(ad) == 2 * 2                       # q and v, per layer
    assert sorted(ad) == sorted(jlora.init(
        jax.tree_util.tree_map(jnp.asarray, params), ("q_proj", "v_proj"),
        rank=4))
    base = dict(tm.named_parameters())
    merged = lora.merge(base, ad, lora.scale(16, 4))
    assert set(merged) == set(base)
    for n, p in base.items():
        assert torch.equal(merged[n], p), n
    # A ~ N(0, 1/rank): std 1/sqrt(rank)
    a_all = torch.cat([ad[k]["a"].reshape(-1) for k in ad])
    np.testing.assert_allclose(float(a_all.detach().std()), 0.5, rtol=0.1)
    small, full = lora.num_params(ad)
    # q: a (4, 32), b (32, 4); v: a (4, 32), b (16, 4); two layers
    assert (small, full) == (2 * (128 + 128 + 128 + 64),
                             2 * (32 * 32 + 16 * 32))


def test_merge_matches_jax(llama):
    """Nonzero adapters from the JAX package: the merged weights at rtol
    1e-6 of the JAX merge, the adapters carried both ways bitwise, and
    the base untouched."""
    _, params = llama
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jad = jlora.init(jp, ("q_proj", "v_proj", "down_proj"), rank=4,
                     key=jax.random.PRNGKey(5))
    rs = np.random.RandomState(6)
    jad = {k: {"a": v["a"], "b": jnp.asarray(rs.randn(*v["b"].shape),
                                             jnp.float32)}
           for k, v in jad.items()}
    jm = jlora.merge(jp, jad, jlora.scale(8, 4))
    tm = _port(params)
    before = {n: p.clone() for n, p in tm.named_parameters()}
    ad = adapters_from_jax(jad)
    for k, v in adapters_to_jax(ad).items():
        for part in ("a", "b"):
            assert v[part].tobytes() == np.asarray(jad[k][part]).tobytes()
    merged = lora.merge(dict(tm.named_parameters()), ad, lora.scale(8, 4))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jm))
    for n, w in want.items():
        np.testing.assert_allclose(merged[n].detach().numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-7)
    for n, p in tm.named_parameters():
        assert torch.equal(p, before[n]), n


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_adapter_only_training_learns_and_freezes_base(llama, opt_level):
    """The adapters as the model of ``amp.initialize`` and ``make_step``;
    the loss on merged weights.  The loss falls and the base stays
    bitwise as it was, its parameters taking no grads."""
    _, params = llama
    tm = _port(params)
    tm.requires_grad_(False)
    before = {n: p.clone() for n, p in tm.state_dict().items()}
    ad = lora.init(tm, targets=("q_proj", "v_proj", "gate_proj", "up_proj",
                                "down_proj", "o_proj"), rank=8,
                   generator=torch.Generator().manual_seed(2))
    s = lora.scale(16, 8)
    ids = _t(np.random.RandomState(0).randint(0, 97, (2, 16)))
    ad, opt = amp.initialize(ad, optimizers.FusedAdam(lr=1e-2),
                             opt_level=opt_level, verbosity=0)

    def step(batch):
        loss, grads = amp.scaled_grad(
            lambda: _merged_loss(tm, ad, s, batch), opt)
        opt.step(grads)
        return loss

    train = parallel.make_step(step, ad)
    losses = [float(train(ids)) for _ in range(40)]
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    for n, v in tm.state_dict().items():
        assert torch.equal(v, before[n]), n
    assert all(p.grad is None for p in tm.parameters())
    small, full = lora.num_params(ad)
    assert small < full / 2


def test_merged_weights_generate_and_quantize(llama):
    _, params = llama
    tm = _port(params)
    ad = lora.init(tm, targets=("q_proj",), rank=2,
                   generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for k in ad:
            ad[k]["b"].add_(0.01)
            ad[k]["a"].add_(0.01)
    merged = lora.merge(dict(tm.named_parameters()), ad, lora.scale(8, 2))
    served = models.Llama(models.LlamaConfig(**KW), device="cpu")
    served.load_state_dict({n: t.detach() for n, t in merged.items()})
    assert not torch.equal(served.layers[0].self_attn.q_proj.weight,
                           tm.layers[0].self_attn.q_proj.weight)
    buf = torch.zeros((1, 16), dtype=torch.int64)
    buf[0, :4] = torch.tensor([5, 9, 2, 7])
    out, n = served.generate_cached(buf, 4, 6)
    assert int(n[0]) == 10
    q = quantization.quantize_for_decode(served, min_size=256)
    out2, _ = q.generate_cached(buf, 4, 6)
    assert out2.shape == out.shape


def test_gpt_targets_and_errors():
    gm = models.GPT(models.GPTConfig(vocab_size=64, block_size=16, n_layer=2,
                                     n_head=4, n_embd=32, dropout=0.0),
                    device="cpu")
    ad = lora.init(gm, targets=("qkv",), rank=4)
    assert sorted(ad) == ["h/0/attn/qkv/weight", "h/1/attn/qkv/weight"]
    with pytest.raises(ValueError, match="no 2-D weights"):
        lora.init(gm, targets=("nonexistent",))
    with pytest.raises(ValueError, match="rank"):
        lora.init(gm, targets=("qkv",), rank=0)
    with pytest.raises(KeyError, match="adapter paths"):
        lora.merge(dict(gm.named_parameters()),
                   {"h/9/attn/qkv/weight": ad["h/0/attn/qkv/weight"]})
