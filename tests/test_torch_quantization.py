"""Weight-only int8 quantization of the port against the JAX package on
the CPU.

``quantize`` gives the JAX package's int8 data and fp32 scales bitwise;
the error is within half a step; ``quantize_for_decode`` picks the same
weights and leaves the model it copies untouched; ``linear``,
``embedding`` and the LM heads on a ``QTensor`` equal the JAX package's
at rtol 1e-5 (fp32 logical dtype, so the products compare in fp32); a
quantized GPT and BERT run forward, loss and both decode loops.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import models as jmodels
from apex_tpu import quantization as jquant
from apex_tpu.nn import functional as JF

from apex_tpu_torch import models, quantization
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.quantization import QTensor, quantize
from apex_tpu_torch.utils.jax_interop import (params_from_jax,
                                              qtensor_from_jax,
                                              qtensor_to_jax)

GPT_CFG = dict(vocab_size=211, block_size=32, n_layer=2, n_head=4,
               n_embd=64, dropout=0.0, head_chunk=None)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("shape,axis", [((64, 48), 0), ((48, 64), 1),
                                        ((3, 5, 7), 0), ((33,), 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bitwise_jax(shape, axis, dtype):
    """int8 data and fp32 scales bitwise the JAX package's, ties and a
    zero row included; the interop carries the QTensor both ways."""
    rs = np.random.RandomState(0)
    w = rs.randn(*shape).astype(np.float32)
    w.reshape(shape[0], -1)[0] = 0.0                 # a zero row
    w.reshape(-1)[1:6] = [0.5, -1.5, 2.5, 127.0, -127.0]
    jw = jnp.asarray(w, dtype)
    jq = jquant.quantize(jw, axis=axis, dtype=jnp.float32)
    tq = quantize(_t(np.asarray(jw)) if dtype == "float32"
                  else torch.from_numpy(w).to(torch.bfloat16), axis=axis,
                  dtype=torch.float32)
    assert tq.data.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    assert tq.scale.numpy().tobytes() == np.asarray(jq.scale).tobytes()
    back = qtensor_to_jax(tq)
    assert back["axis"] == axis and back["dtype"] == "float32"
    again = qtensor_from_jax(jquant.QTensor(back["data"], back["scale"],
                                            axis, jnp.float32))
    assert torch.equal(again.data, tq.data)
    assert torch.equal(again.scale, tq.scale)


def test_quantize_error_bound():
    w = torch.from_numpy(np.random.RandomState(1).randn(64, 48).astype(
        np.float32))
    q = quantize(w, axis=0, dtype=torch.float32)
    assert q.shape == w.shape and q.dtype == torch.float32
    err = (q.dequant() - w).abs()
    assert bool((err <= q.scale * 0.5 + 1e-7).all())


def test_ops_on_a_qtensor_match_jax():
    """linear (with a bias, fp32 and bf16 activations), embedding rows and
    the head's ``table.T.astype`` against the JAX package's."""
    rs = np.random.RandomState(2)
    w = rs.randn(32, 24).astype(np.float32) * 0.1
    b = rs.randn(32).astype(np.float32)
    x = rs.randn(4, 24).astype(np.float32)
    for ldt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        jq = jquant.quantize(jnp.asarray(w), dtype=jdt)
        tq = qtensor_from_jax(jq)
        assert tq.dtype == ldt
        _close(F.linear(_t(x), tq, _t(b)).float().numpy(),
               JF.linear(jnp.asarray(x), jq, jnp.asarray(b)))
        _close(F.linear(_t(x), tq).float().numpy(),
               JF.linear(jnp.asarray(x), jq))
    tab = rs.randn(50, 16).astype(np.float32)
    jt = jquant.quantize(jnp.asarray(tab), dtype=jnp.float32)
    tt = qtensor_from_jax(jt)
    ids = np.asarray([[0, 7], [49, 7]])
    np.testing.assert_array_equal(F.embedding(_t(ids), tt).numpy(),
                                  np.asarray(JF.embedding(jnp.asarray(ids),
                                                          jt)))
    np.testing.assert_array_equal(tt.T.numpy(), np.asarray(jt.T))
    np.testing.assert_array_equal(tt.astype(torch.bfloat16).float().numpy(),
                                  np.asarray(jt.astype(jnp.bfloat16),
                                             np.float32))
    with pytest.raises(ValueError, match="axis=0"):
        quantize(_t(tab), axis=1).take(_t(ids))


@pytest.fixture(scope="module")
def gpt_weights():
    params, _ = jmodels.GPT(jmodels.GPTConfig(**GPT_CFG)).init(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def test_quantize_for_decode_selects_the_jax_leaves(gpt_weights):
    jq = jquant.quantize_for_decode(jax.tree_util.tree_map(
        jnp.asarray, gpt_weights), min_size=256)
    want = {'.'.join(str(k.key) for k in path[:-1])
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jq, is_leaf=lambda x: isinstance(x, jquant.QTensor))[0]
            if isinstance(leaf, jquant.QTensor)}
    tm = models.GPT(models.GPTConfig(**GPT_CFG), device="cpu")
    tm.load_state_dict(params_from_jax(gpt_weights))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    qm = quantization.quantize_for_decode(tm, min_size=256)
    got = {n for n, m in qm.named_modules() if isinstance(m, QTensor)}
    assert got == {f"{p}.weight" for p in want} and "wte.weight" in got
    # norms and biases stay fp32 parameters; the quantized model's state
    # dict holds the int8 storage
    assert qm.ln_f.weight.dtype == torch.float32
    sd = qm.state_dict()
    assert sd["wte.weight.data"].dtype == torch.int8
    assert sd["wte.weight.scale"].shape == (GPT_CFG["vocab_size"], 1)
    # the original is untouched: the same parameters, bitwise
    after = tm.state_dict()
    assert set(after) == set(before)
    for k in before:
        assert torch.equal(after[k], before[k]), k
    assert isinstance(tm.wte.weight, torch.nn.Parameter)
    # the JAX package's quantized tree loads into the quantized model
    qm2 = quantization.quantize_for_decode(
        models.GPT(models.GPTConfig(**GPT_CFG), device="cpu"), min_size=256)
    qm2.load_state_dict(params_from_jax(jq))
    for k, v in qm2.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # a move keeps the storage dtypes; a cast of the model does too
    qm.to("cpu", torch.float16)
    assert qm.wte.weight.data.dtype == torch.int8
    assert torch.equal(qm.wte.weight.scale, sd["wte.weight.scale"])


def test_quantized_gpt_matches_jax(gpt_weights):
    """Logits and the loss of a quantized GPT (fp32 logical dtype) at rtol
    1e-5 against the JAX package's, and both decode loops' tokens."""
    jm = jmodels.GPT(jmodels.GPTConfig(**GPT_CFG))
    jq = jquant.quantize_for_decode(jax.tree_util.tree_map(
        jnp.asarray, gpt_weights), dtype=jnp.float32, min_size=256)
    tm = models.GPT(models.GPTConfig(**GPT_CFG), device="cpu")
    tm.load_state_dict(params_from_jax(gpt_weights))
    qm = quantization.quantize_for_decode(tm, dtype=torch.float32,
                                          min_size=256)
    ids = np.random.RandomState(3).randint(0, 211, (2, 32)).astype(np.int32)
    jl = jax.jit(lambda p: jm(p, jnp.asarray(ids)))(jq)
    jloss = jax.jit(lambda p: jm.loss(p, jnp.asarray(ids)))(jq)
    with torch.no_grad():
        _close(qm(_t(ids)).numpy(), jl)
        np.testing.assert_allclose(float(qm.loss(_t(ids))), float(jloss),
                                   rtol=1e-5)
        lf = tm(_t(ids)).numpy()
    rel = np.abs(np.asarray(jl) - lf) / (np.abs(lf).max() + 1e-6)
    assert rel.max() < 0.05, rel.max()
    buf = np.zeros((2, 32), np.int32)
    buf[:, :4] = ids[:, :4]
    jo, _ = jax.jit(lambda p: jm.generate_cached(p, jnp.asarray(buf), 4,
                                                  8))(jq)
    out, n = qm.generate(_t(buf), 4, 8)
    assert list(n.numpy()) == [12, 12]
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    out_c, _ = qm.generate_cached(_t(buf), 4, 8)
    np.testing.assert_array_equal(out_c.numpy(), np.asarray(jo))
    # with the int8 cache too (the bf16 logical dtype's cache by default)
    q16 = quantization.quantize_for_decode(tm, min_size=256)
    out8, n8 = q16.generate_cached(_t(buf), 4, 8, cache_dtype=torch.int8)
    assert out8.shape == (2, 32) and list(n8.numpy()) == [12, 12]


def test_quantized_bert_forward_and_loss():
    """A quantized BertForPretraining: logits within 5 % of the fp model's
    (bf16 logical dtype, as the JAX test) and at rtol 1e-5 of the JAX
    package's quantized model in fp32; the loss finite."""
    kw = dict(vocab_size=223, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=32, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    jm = jmodels.BertForPretraining(jmodels.BertConfig(**kw))
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = models.BertForPretraining(models.BertConfig(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 223, (2, 16)).astype(np.int32)
    jq = jquant.quantize_for_decode(params, dtype=jnp.float32, min_size=256)
    jl, _ = jax.jit(lambda p: jm(p, jnp.asarray(ids)))(jq)
    q32 = quantization.quantize_for_decode(tm, dtype=torch.float32,
                                           min_size=256)
    q16 = quantization.quantize_for_decode(tm, min_size=256)
    mlm = np.where(rs.rand(2, 16) < 0.15, rs.randint(0, 223, (2, 16)), -100)
    nsp = rs.randint(0, 2, 2)
    with torch.no_grad():
        _close(q32(_t(ids))[0].numpy(), jl)
        lf = tm(_t(ids))[0].numpy()
        lq = q16(_t(ids))[0].float().numpy()
        loss = q16.loss(_t(ids), _t(mlm), _t(nsp))
    rel = np.abs(lq - lf) / (np.abs(lf).max() + 1e-6)
    assert rel.max() < 0.05, rel.max()
    assert np.isfinite(float(loss))


def test_quantized_vocab_parallel_embedding_waits_for_item_6():
    """The JAX package quantizes a vocab-sharded table
    (``VocabParallelEmbedding``); the port has no tensor parallelism yet."""
    from apex_tpu_torch.models import GPTConfig
    with pytest.raises(NotImplementedError, match="item 6"):
        GPTConfig(tp_axis="tp")


def test_quantizing_an_amp_model():
    """An O2 model, whose forward amp patched: the copy's forward runs the
    copy (and casts its logits to fp32, as amp's does); the copy is bound
    to no optimizer, the original still is."""
    from apex_tpu_torch import amp, optimizers
    tm = models.GPT(models.GPTConfig(**GPT_CFG), device="cpu")
    model, opt = amp.initialize(tm, optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", verbosity=0)
    q = quantization.quantize_for_decode(model, min_size=256)
    ids = _t(np.random.RandomState(4).randint(0, 211, (2, 16)))
    with torch.no_grad():
        lf, lq = model(ids), q(ids)
        assert lq.dtype == torch.float32 and not torch.equal(lq, lf)
        q.h[0].attn.qkv.weight.data.zero_()
        assert not torch.equal(q(ids), lq)
        assert torch.equal(model(ids), lf)
    assert model._amp_optimizer is opt and not hasattr(q, "_amp_optimizer")
