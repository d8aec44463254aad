"""The port's HF converters against transformers and the JAX package's
converters, on the CPU.

Each converter takes a tiny random transformers model (built from a
config object, no download) and gives the port's model; its fp32 outputs
are held at atol 1e-5 against the transformers model's and against the
model the JAX package's converter gives.  Also: ``llama_to_hf`` through
``LlamaForCausalLM`` and back, bitwise; the refusals.
"""

from types import SimpleNamespace

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from apex_tpu import models as jmodels  # noqa: E402
from apex_tpu.utils import hf_interop as jhf  # noqa: E402

from apex_tpu_torch.utils import hf_interop  # noqa: E402

ATOL = 1e-5


def _ids(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def _decoder_case(name):
    """(hf model, port converter, JAX converter, JAX model class) of one
    decoder family at the JAX tests' tiny widths."""
    T = transformers
    common = dict(vocab_size=151, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=48, attn_implementation="eager")
    if name == "llama":
        hf = T.LlamaForCausalLM(T.LlamaConfig(num_key_value_heads=2,
                                              **common))
    elif name == "llama_tied":
        hf = T.LlamaForCausalLM(T.LlamaConfig(num_key_value_heads=1,
                                              tie_word_embeddings=True,
                                              **common))
    elif name == "mistral":
        hf = T.MistralForCausalLM(T.MistralConfig(
            num_key_value_heads=2, sliding_window=8,
            tie_word_embeddings=False, **common))
    elif name == "qwen2":
        hf = T.Qwen2ForCausalLM(T.Qwen2Config(num_key_value_heads=2,
                                              tie_word_embeddings=False,
                                              **common))
    elif name == "gemma":
        hf = T.GemmaForCausalLM(T.GemmaConfig(**dict(
            common, hidden_size=48, intermediate_size=96),
            num_key_value_heads=2, head_dim=20))
    elif name == "neox":
        hf = T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
            rotary_pct=0.25, tie_word_embeddings=False, **common))
    family = {"llama_tied": "llama"}.get(name, name)
    conv = {"neox": "gpt_neox"}.get(family, family) + "_from_hf"
    return hf.eval(), conv


@pytest.mark.parametrize("name", ["llama", "llama_tied", "mistral", "qwen2",
                                  "gemma", "neox"])
def test_decoder_families_match(name):
    torch.manual_seed(0)
    hf, conv = _decoder_case(name)
    tm = getattr(hf_interop, conv)(hf, device="cpu")
    cfg, jp = getattr(jhf, conv)(hf)
    jm = jmodels.Llama(cfg)
    ids = _ids(0, (2, 24), 151)
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.numpy()
        got = tm(torch.from_numpy(ids)).numpy()
    want = np.asarray(jax.jit(lambda p: jm(p, jnp.asarray(ids)))(jp))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the same weights, fp32, as the JAX converter gives them
    for n, t in tm.state_dict().items():
        leaf = jp
        for part in n.split("."):
            leaf = leaf[part]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("with_mask", [False, True])
def test_bert_matches(with_mask):
    hf_cfg = transformers.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=16, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(1)
    hf = transformers.BertModel(hf_cfg).eval()
    tm = hf_interop.bert_from_hf(hf, device="cpu").eval()
    cfg, jp = jhf.bert_from_hf(hf)
    jm = jmodels.BertModel(cfg)
    ids, tt = _ids(1, (2, 10), 64), _ids(2, (2, 10), 2)
    mask = ((np.arange(10)[None, :] < [[7], [4]]).astype(np.int64)
            if with_mask else np.ones((2, 10), np.int64))
    with torch.no_grad():
        out = hf(input_ids=torch.tensor(ids), token_type_ids=torch.tensor(tt),
                 attention_mask=torch.tensor(mask))
        seq, pooled = tm(torch.tensor(ids), torch.tensor(tt),
                         torch.tensor(mask) if with_mask else None)
    jseq, jpooled = jax.jit(lambda p: jm(
        p, jnp.asarray(ids), token_type_ids=jnp.asarray(tt),
        attention_mask=jnp.asarray(mask) if with_mask else None))(jp)
    # the valid positions (a padded query's row is garbage on every side)
    for b, n in enumerate((7, 4) if with_mask else (10, 10)):
        np.testing.assert_allclose(seq[b, :n].numpy(),
                                   out.last_hidden_state[b, :n].numpy(),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(seq[b, :n].numpy(),
                                   np.asarray(jseq)[b, :n], rtol=0,
                                   atol=ATOL)
    if not with_mask:
        np.testing.assert_allclose(pooled.numpy(),
                                   out.pooler_output.numpy(), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                                   rtol=0, atol=ATOL)


def test_gpt2_matches():
    hf_cfg = transformers.GPT2Config(
        vocab_size=64, n_positions=16, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(2)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    tm = hf_interop.gpt_from_hf(hf.transformer, device="cpu")
    cfg, jp = jhf.gpt_from_hf(hf.transformer)
    ids = _ids(2, (2, 12), 64)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids)).logits.numpy()
        got = tm(torch.tensor(ids)).numpy()
    want = np.asarray(jax.jit(lambda p: jmodels.GPT(cfg)(
        p, jnp.asarray(ids)))(jp))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("layer_type,hidden_sizes,head", [
    ("basic", [64, 128, 256, 512], True),
    ("bottleneck", [256, 512, 1024, 2048], False)])
def test_resnet_matches(layer_type, hidden_sizes, head):
    """Strides, shortcut projections, BatchNorm statistics and the head
    (a base model's head is zeros on every side)."""
    cfg = transformers.ResNetConfig(embedding_size=64,
                                    hidden_sizes=hidden_sizes,
                                    depths=[1, 1, 1, 1],
                                    layer_type=layer_type, num_labels=7)
    torch.manual_seed(0)
    hf = (transformers.ResNetForImageClassification(cfg) if head
          else transformers.ResNetModel(cfg)).eval()
    # statistics off their init, so they count
    with torch.no_grad():
        for m in hf.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    tm = hf_interop.resnet_from_hf(hf, device="cpu").eval()
    jm, jp, js = jhf.resnet_from_hf(hf)
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda p, s: jm.apply(
        p, jnp.asarray(x), state=s, train=False)[0])(jp, js))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if head:
        with torch.no_grad():
            ref = hf(torch.from_numpy(x)).logits.numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    else:
        assert not got.any()


def test_resnet_refuses_the_v1_geometry():
    cfg = transformers.ResNetConfig(embedding_size=64,
                                    hidden_sizes=[256, 512, 1024, 2048],
                                    depths=[1, 1, 1, 1],
                                    layer_type="bottleneck",
                                    downsample_in_bottleneck=True)
    with pytest.raises(ValueError, match="v1.0 geometry"):
        hf_interop.resnet_from_hf(transformers.ResNetModel(cfg),
                                  device="cpu")


@pytest.mark.parametrize("ff,tie", [("relu", True), ("gated-gelu", False)])
def test_t5_matches(ff, tie):
    hf_cfg = transformers.T5Config(
        vocab_size=151, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_decoder_layers=2, num_heads=4,
        relative_attention_num_buckets=8,
        relative_attention_max_distance=20, feed_forward_proj=ff,
        tie_word_embeddings=tie, dropout_rate=0.0, decoder_start_token_id=0,
        eos_token_id=1, pad_token_id=0)
    torch.manual_seed(0)
    hf = transformers.T5ForConditionalGeneration(hf_cfg).eval()
    tm = hf_interop.t5_from_hf(hf, device="cpu")
    cfg, jp = jhf.t5_from_hf(hf)
    ids, dec = _ids(0, (2, 12), 151), _ids(1, (2, 7), 151)
    mask = np.ones((2, 12), np.int64)
    mask[0, 6:] = 0
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask),
                 decoder_input_ids=torch.from_numpy(dec)).logits.numpy()
        got = tm(torch.from_numpy(ids), torch.from_numpy(dec),
                 torch.from_numpy(mask)).numpy()
    from apex_tpu.models import T5 as JT5
    want = np.asarray(jax.jit(lambda p: JT5(cfg)(
        p, jnp.asarray(ids), jnp.asarray(dec), jnp.asarray(mask)))(jp))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_llama_to_hf_round_trip():
    """A port Llama exported, loaded by ``LlamaForCausalLM`` (the same
    logits), converted back bitwise; then through a duck-typed shim."""
    from apex_tpu_torch import models
    cfg = models.LlamaConfig(vocab_size=151, hidden_size=64,
                             intermediate_size=128, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=48,
                             tie_word_embeddings=False)
    m = models.Llama(cfg, device="cpu")
    sd = hf_interop.llama_to_hf(cfg, m.state_dict())
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=151, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=48, tie_word_embeddings=False,
        attn_implementation="eager")).eval()
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all("rotary" in k or "inv_freq" in k for k in missing), missing
    ids = _ids(0, (2, 20), 151)
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.numpy()
        got = m(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    for src in (hf, SimpleNamespace(config=hf.config,
                                    state_dict=lambda: sd)):
        back = hf_interop.llama_from_hf(src, device="cpu")
        for n, t in m.state_dict().items():
            assert torch.equal(back.state_dict()[n], t), n


def test_mixtral_waits_for_item_6():
    with pytest.raises(NotImplementedError, match="item 6"):
        hf_interop.mixtral_from_hf(None, device="cpu")
