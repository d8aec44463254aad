"""HuggingFace checkpoints to the port's models, and a Llama back.

Counterpart of ``apex_tpu/utils/hf_interop.py``.  Each converter takes a
duck-typed HF model, anything with ``.config`` (HF's config fields) and
``.state_dict()``, and returns the port's model with those weights, as
fp32 copies on ``device`` (the GPU unless the caller says otherwise):

    model = hf_interop.llama_from_hf(hf_llama)      # a models.Llama

The conventions are the JAX package's: BERT's separate q/k/v fuse into
the [q; k; v] rows of its ``qkv`` weight, GPT-2's Conv1D weights
transpose into the (out, in) Linear layout, GPT-NeoX's fused
``query_key_value`` rows, interleaved per head, split into q/k/v, and
Mistral, Qwen2, Gemma and NeoX become Llama knobs.  ``llama_to_hf`` goes
the other way.  The module works without the ``transformers`` package: a
model built from it, or a checkpoint's state dict behind a stand-in, is
all it takes.

The model is built on the ``meta`` device and takes the converted
tensors as its parameters (``load_state_dict(assign=True)``), so no
random weights are drawn for a checkpoint.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from .._device import resolve_device

__all__ = ["bert_from_hf", "gpt_from_hf", "resnet_from_hf", "llama_from_hf",
           "mixtral_from_hf", "mistral_from_hf", "qwen2_from_hf",
           "gemma_from_hf", "gpt_neox_from_hf", "llama_to_hf", "t5_from_hf"]


def _materialize(build, sd: Mapping[str, torch.Tensor], device):
    """``build(device)`` on the meta device, then ``sd`` loaded in as its
    parameters and buffers: copies on ``device`` in the model's own
    dtypes (fp32 weights, integer counters as the port keeps them)."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = build(torch.device("meta"))
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"converted weights do not fit the model: missing "
                       f"{missing[:4]}, unexpected {unexpected[:4]}")
    model.load_state_dict(
        {k: v.detach().to(device=device, dtype=own[k].dtype, copy=True)
         for k, v in sd.items()}, assign=True)
    return model


def _generator(device):
    """A dropout generator on the model's device (seeded 0)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(0)


def bert_from_hf(hf_model, device=None):
    """A ``models.BertModel`` from a transformers ``BertModel``."""
    from ..models import BertConfig, BertModel
    hc = hf_model.config
    if hc.hidden_act != "gelu":
        raise ValueError(
            f"unsupported source activation {hc.hidden_act!r}: the "
            f"converter maps HF's default 'gelu' (exact erf); other "
            f"activations would silently diverge")
    cfg = BertConfig(vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
                     num_hidden_layers=hc.num_hidden_layers,
                     num_attention_heads=hc.num_attention_heads,
                     intermediate_size=hc.intermediate_size,
                     max_position_embeddings=hc.max_position_embeddings,
                     type_vocab_size=hc.type_vocab_size,
                     hidden_dropout_prob=hc.hidden_dropout_prob,
                     attention_probs_dropout_prob=(
                         hc.attention_probs_dropout_prob),
                     layer_norm_eps=hc.layer_norm_eps,
                     hidden_act="gelu_exact")
    src = hf_model.state_dict()
    sd: Dict[str, torch.Tensor] = {}
    for k in ("weight", "bias"):
        for i in range(hc.num_hidden_layers):
            hb, pb = f"encoder.layer.{i}", f"layer.{i}"
            # fused qkv: rows [q; k; v], BertSelfAttention's reshape order
            sd[f"{pb}.attention.qkv.{k}"] = torch.cat(
                [src[f"{hb}.attention.self.{n}.{k}"]
                 for n in ("query", "key", "value")], 0)
            for ours, theirs in (("attention.out", "attention.output.dense"),
                                 ("attention_ln",
                                  "attention.output.LayerNorm"),
                                 ("intermediate", "intermediate.dense"),
                                 ("output", "output.dense"),
                                 ("output_ln", "output.LayerNorm")):
                sd[f"{pb}.{ours}.{k}"] = src[f"{hb}.{theirs}.{k}"]
        sd[f"embeddings_ln.{k}"] = src[f"embeddings.LayerNorm.{k}"]
        sd[f"pooler.{k}"] = src[f"pooler.dense.{k}"]
    for n in ("word", "position", "token_type"):
        sd[f"{n}_embeddings.weight"] = src[f"embeddings.{n}_embeddings.weight"]
    return _materialize(lambda d: BertModel(
        cfg, device=d, dropout_generator=_generator(device)), sd, device)


def gpt_from_hf(hf_model, device=None):
    """A ``models.GPT`` from a transformers ``GPT2Model``.  GPT-2's Conv1D
    stores (in, out); Linear takes (out, in): transposed here."""
    from ..models import GPT, GPTConfig
    hc = hf_model.config
    if hc.activation_function != "gelu_new":
        raise ValueError(
            f"unsupported source activation {hc.activation_function!r}: "
            f"the converter maps GPT-2's default 'gelu_new' (tanh)")
    if not (hc.resid_pdrop == hc.attn_pdrop == hc.embd_pdrop):
        raise ValueError(
            f"GPTConfig has one dropout rate; the source has "
            f"resid={hc.resid_pdrop} attn={hc.attn_pdrop} "
            f"embd={hc.embd_pdrop} — make them equal (or zero for "
            f"inference) before converting")
    cfg = GPTConfig(vocab_size=hc.vocab_size, block_size=hc.n_positions,
                    n_layer=hc.n_layer, n_head=hc.n_head, n_embd=hc.n_embd,
                    dropout=hc.resid_pdrop,
                    layer_norm_eps=hc.layer_norm_epsilon)
    src = hf_model.state_dict()
    sd = {"wte.weight": src["wte.weight"], "wpe.weight": src["wpe.weight"],
          "ln_f.weight": src["ln_f.weight"], "ln_f.bias": src["ln_f.bias"]}
    for i in range(hc.n_layer):
        for ours, theirs in (("ln_1", "ln_1"), ("ln_2", "ln_2")):
            for k in ("weight", "bias"):
                sd[f"h.{i}.{ours}.{k}"] = src[f"h.{i}.{theirs}.{k}"]
        for ours, theirs in (("attn.qkv", "attn.c_attn"),
                             ("attn.out", "attn.c_proj"),
                             ("fc", "mlp.c_fc"), ("proj", "mlp.c_proj")):
            sd[f"h.{i}.{ours}.weight"] = src[f"h.{i}.{theirs}.weight"].t()
            sd[f"h.{i}.{ours}.bias"] = src[f"h.{i}.{theirs}.bias"]
    return _materialize(lambda d: GPT(
        cfg, device=d, dropout_generator=_generator(device)), sd, device)


def resnet_from_hf(hf_model, device=None):
    """A ``models.ResNet`` from a transformers ``ResNetModel`` /
    ``ResNetForImageClassification``, BatchNorm statistics included.
    HF's default geometry (stride in the bottleneck's 3x3, v1.5) is the
    port's, so the mapping is renaming; a base model's head is zeros."""
    from ..models import BasicBlock, Bottleneck, ResNet
    hc = hf_model.config
    if getattr(hc, "downsample_in_first_stage", False):
        raise ValueError("downsample_in_first_stage=True has no "
                         "equivalent in the torchvision-shaped ResNet")
    if getattr(hc, "downsample_in_bottleneck", False):
        raise ValueError("downsample_in_bottleneck=True (v1.0 geometry) "
                         "is not supported; this ResNet strides in the "
                         "3x3 (v1.5, HF default)")
    if hc.layer_type == "bottleneck":
        block, exp = Bottleneck, 4
    elif hc.layer_type == "basic":
        block, exp = BasicBlock, 1
    else:
        raise ValueError(f"unknown layer_type {hc.layer_type!r}")
    if hc.embedding_size != 64 or hc.hidden_act != "relu":
        raise ValueError("only the standard embedding_size=64 / relu "
                         "geometry maps onto models.ResNet")
    expected = [64 * exp * (2 ** i) for i in range(len(hc.depths))]
    if list(hc.hidden_sizes) != expected or len(hc.depths) != 4:
        raise ValueError(f"hidden_sizes {hc.hidden_sizes} do not match "
                         f"the standard progression {expected}")
    src = hf_model.state_dict()
    # ForImageClassification nests the backbone under "resnet."
    if "embedder.embedder.convolution.weight" not in src:
        src = {(k[len("resnet."):] if k.startswith("resnet.") else k): v
               for k, v in src.items()}
    n_classes = getattr(hc, "num_labels", None) or 1000

    def bn(ours, theirs):
        for k in ("weight", "bias", "running_mean", "running_var",
                  "num_batches_tracked"):
            sd[f"{ours}.{k}"] = src[f"{theirs}.{k}"]

    sd = {"conv1.weight": src["embedder.embedder.convolution.weight"]}
    bn("bn1", "embedder.embedder.normalization")
    nconvs = 3 if block is Bottleneck else 2
    for s, depth in enumerate(hc.depths):
        for l in range(depth):
            hfp, ours = f"encoder.stages.{s}.layers.{l}", f"layer{s + 1}.{l}"
            for j in range(nconvs):
                sd[f"{ours}.conv{j + 1}.weight"] = src[
                    f"{hfp}.layer.{j}.convolution.weight"]
                bn(f"{ours}.bn{j + 1}", f"{hfp}.layer.{j}.normalization")
            if f"{hfp}.shortcut.convolution.weight" in src:
                sd[f"{ours}.downsample.0.weight"] = src[
                    f"{hfp}.shortcut.convolution.weight"]
                bn(f"{ours}.downsample.1", f"{hfp}.shortcut.normalization")
    if "classifier.1.weight" in src:
        sd["fc.weight"] = src["classifier.1.weight"]
        sd["fc.bias"] = src["classifier.1.bias"]
    else:       # a base model: the head stays zeros (the caller's to set)
        sd["fc.weight"] = torch.zeros((n_classes, expected[-1]))
        sd["fc.bias"] = torch.zeros((n_classes,))
    return _materialize(lambda d: ResNet(block, list(hc.depths),
                                         num_classes=n_classes, device=d),
                        sd, device)


def _llama_cfg(hc, **knobs):
    from ..models import LlamaConfig
    return LlamaConfig(
        vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
        intermediate_size=hc.intermediate_size,
        num_hidden_layers=hc.num_hidden_layers,
        num_attention_heads=hc.num_attention_heads,
        num_key_value_heads=knobs.pop(
            "num_key_value_heads", getattr(hc, "num_key_value_heads", None)),
        max_position_embeddings=hc.max_position_embeddings,
        rms_norm_eps=knobs.pop("rms_norm_eps", None) or hc.rms_norm_eps,
        rope_theta=knobs.pop("rope_theta", None) or hc.rope_theta,
        tie_word_embeddings=knobs.pop("tie_word_embeddings",
                                      hc.tie_word_embeddings),
        **knobs)


def _llama_sd(hc, src, attn_bias=False, head="lm_head.weight"):
    """The Llama key mapping (HF's names under ``model.`` or bare), biases
    on q/k/v with ``attn_bias``; an untied model without ``head`` gets a
    zero head (a bare ``LlamaModel``)."""
    base = "model." if "model.embed_tokens.weight" in src else ""
    sd = {"embed_tokens.weight": src[f"{base}embed_tokens.weight"],
          "norm.weight": src[f"{base}norm.weight"]}
    for i in range(hc.num_hidden_layers):
        b, ours = f"{base}layers.{i}", f"layers.{i}"
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{ours}.{n}.weight"] = src[f"{b}.{n}.weight"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{ours}.self_attn.{n}.weight"] = src[
                f"{b}.self_attn.{n}.weight"]
            if attn_bias and n != "o_proj":
                sd[f"{ours}.self_attn.{n}.bias"] = src[
                    f"{b}.self_attn.{n}.bias"]
        for n in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{ours}.mlp.{n}.weight"] = src[f"{b}.mlp.{n}.weight"]
    return sd


def _with_head(sd, hc, src, head):
    if not hc.tie_word_embeddings:
        sd["lm_head.weight"] = (src[head] if head in src else torch.zeros(
            (hc.vocab_size, hc.hidden_size)))
    return sd


def _llama(cfg, sd, device):
    from ..models import Llama
    return _materialize(lambda d: Llama(cfg, device=d), sd, device)


def llama_from_hf(hf_model, device=None):
    """A ``models.Llama`` from a transformers ``LlamaModel`` /
    ``LlamaForCausalLM``: the same layout renamed (RoPE has no
    weights)."""
    hc = hf_model.config
    if getattr(hc, "hidden_act", "silu") != "silu":
        raise ValueError(f"unsupported activation {hc.hidden_act!r}")
    if getattr(hc, "attention_bias", False):
        raise ValueError("attention_bias=True is not mapped")
    if getattr(hc, "mlp_bias", False):
        raise ValueError("mlp_bias=True is not mapped (gate/up/down "
                         "biases would be silently dropped)")
    if getattr(hc, "rope_scaling", None):
        raise ValueError(
            f"rope_scaling={hc.rope_scaling!r} is not implemented (the "
            f"port's RoPE uses unscaled theta frequencies; a "
            f"Llama-3.1-style scaled checkpoint would convert cleanly but "
            f"generate silently wrong logits)")
    src = hf_model.state_dict()
    return _llama(_llama_cfg(hc), _with_head(_llama_sd(hc, src), hc, src,
                                             "lm_head.weight"), device)


def mixtral_from_hf(hf_model, device=None):
    """Mixtral waits for the port's expert parallelism."""
    raise NotImplementedError(
        "mixtral_from_hf: models/mixtral.py needs parallel/"
        "expert_parallel.py, which is not ported yet: ROADMAP.md queue 1, "
        "item 6")


def mistral_from_hf(hf_model, device=None):
    """A ``models.Llama`` with ``sliding_window`` (None for the full-window
    v0.2+ checkpoints) from a transformers ``MistralModel`` /
    ``MistralForCausalLM``: Llama's key layout."""
    hc = hf_model.config
    if getattr(hc, "hidden_act", "silu") != "silu":
        raise ValueError(f"unsupported activation {hc.hidden_act!r}")
    src = hf_model.state_dict()
    cfg = _llama_cfg(hc, sliding_window=getattr(hc, "sliding_window", None))
    return _llama(cfg, _with_head(_llama_sd(hc, src), hc, src,
                                  "lm_head.weight"), device)


def qwen2_from_hf(hf_model, device=None):
    """A ``models.Llama`` with ``attention_bias=True`` (and a sliding
    window where every layer has one) from a transformers ``Qwen2Model``
    / ``Qwen2ForCausalLM``."""
    hc = hf_model.config
    if getattr(hc, "hidden_act", "silu") != "silu":
        raise ValueError(f"unsupported activation {hc.hidden_act!r}")
    window = None
    if getattr(hc, "use_sliding_window", False):
        # HF bands only the layers >= max_window_layers (layer_types); the
        # port's sliding_window bands every layer: map uniform configs
        # only
        lt = getattr(hc, "layer_types", None) or []
        swa = [t == "sliding_attention" for t in lt]
        if swa and all(swa):
            window = hc.sliding_window
        elif any(swa):
            raise ValueError(
                f"per-layer sliding window (max_window_layers="
                f"{hc.max_window_layers} < num_hidden_layers="
                f"{hc.num_hidden_layers}) is not mapped; the port's "
                f"sliding_window applies to every layer")
    src = hf_model.state_dict()
    cfg = _llama_cfg(hc, attention_bias=True, sliding_window=window)
    return _llama(cfg, _with_head(_llama_sd(hc, src, attn_bias=True), hc,
                                  src, "lm_head.weight"), device)


def gemma_from_hf(hf_model, device=None):
    """A ``models.Llama`` from a transformers ``GemmaModel`` /
    ``GemmaForCausalLM``: a decoupled ``head_dim``, GeGLU
    (``mlp_act="gelu_tanh"``), (1 + w) RMSNorm and the sqrt(hidden)
    embedding scale; tied; Llama's key layout."""
    hc = hf_model.config
    act = (getattr(hc, "hidden_act", None)
           or getattr(hc, "hidden_activation", None))
    if act not in ("gelu", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported activation {act!r}")
    cfg = _llama_cfg(hc, tie_word_embeddings=True, head_dim=hc.head_dim,
                     mlp_act="gelu_tanh", rms_unit_offset=True,
                     embed_scale=True)
    return _llama(cfg, _llama_sd(hc, hf_model.state_dict()), device)


def gpt_neox_from_hf(hf_model, device=None):
    """A ``models.Llama`` from a transformers ``GPTNeoXModel`` /
    ``GPTNeoXForCausalLM`` (Pythia): LayerNorm blocks, the parallel
    residual, partial rotary, biased q/k/v and output dense, the biased
    GeLU MLP.  The fused ``query_key_value`` rows view as (H, 3, D,
    hidden) and split into the three projections."""
    hc = hf_model.config
    if getattr(hc, "hidden_act", "gelu") != "gelu":
        raise ValueError(f"unsupported activation {hc.hidden_act!r}")
    if not getattr(hc, "use_parallel_residual", True):
        raise ValueError("use_parallel_residual=False NeoX variants "
                         "are not mapped")
    cfg = _llama_cfg(
        hc, num_key_value_heads=None, rms_norm_eps=hc.layer_norm_eps,
        rope_theta=getattr(hc, "rotary_emb_base", 10000.0),
        norm_type="layernorm", parallel_residual=True,
        rotary_pct=getattr(hc, "rotary_pct", 1.0), mlp_type="gelu_mlp",
        attention_bias=True, attention_out_bias=True)
    src = hf_model.state_dict()
    base = "gpt_neox." if "gpt_neox.embed_in.weight" in src else ""
    H = hc.num_attention_heads
    E = hc.hidden_size
    D = E // H
    sd = {"embed_tokens.weight": src[f"{base}embed_in.weight"]}
    for k in ("weight", "bias"):
        sd[f"norm.{k}"] = src[f"{base}final_layer_norm.{k}"]
        for i in range(hc.num_hidden_layers):
            b, ours = f"{base}layers.{i}", f"layers.{i}"
            fused = src[f"{b}.attention.query_key_value.{k}"]
            fused = fused.reshape((H, 3, D) + fused.shape[1:])
            for j, n in enumerate(("q_proj", "k_proj", "v_proj")):
                sd[f"{ours}.self_attn.{n}.{k}"] = fused[:, j].reshape(
                    (H * D,) + fused.shape[3:])
            sd[f"{ours}.self_attn.o_proj.{k}"] = src[
                f"{b}.attention.dense.{k}"]
            for n in ("input_layernorm", "post_attention_layernorm"):
                sd[f"{ours}.{n}.{k}"] = src[f"{b}.{n}.{k}"]
            for n in ("dense_h_to_4h", "dense_4h_to_h"):
                sd[f"{ours}.mlp.{n}.{k}"] = src[f"{b}.mlp.{n}.{k}"]
    return _llama(cfg, _with_head(sd, hc, src, "embed_out.weight"), device)


def llama_to_hf(cfg, params: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The inverse of ``llama_from_hf``: a transformers-named state dict
    (``model.``-prefixed, and ``lm_head``) of fp32 copies of ``params``
    (a plain Llama's ``state_dict``), on their device, which
    ``LlamaForCausalLM.load_state_dict`` takes.  Plain Llama only: the
    NeoX and Gemma knobs belong to their own HF classes."""
    def t(name):
        return params[name].detach().to(torch.float32, copy=True)

    sd = {"model.embed_tokens.weight": t("embed_tokens.weight"),
          "model.norm.weight": t("norm.weight")}
    for i in range(cfg.num_hidden_layers):
        b, ours = f"model.layers.{i}", f"layers.{i}"
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{b}.{n}.weight"] = t(f"{ours}.{n}.weight")
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{b}.self_attn.{n}.weight"] = t(f"{ours}.self_attn.{n}.weight")
            if f"{ours}.self_attn.{n}.bias" in params:
                sd[f"{b}.self_attn.{n}.bias"] = t(
                    f"{ours}.self_attn.{n}.bias")
        for n in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{b}.mlp.{n}.weight"] = t(f"{ours}.mlp.{n}.weight")
    if not cfg.tie_word_embeddings and "lm_head.weight" in params:
        sd["lm_head.weight"] = t("lm_head.weight")
    return sd


def t5_from_hf(hf_model, device=None):
    """A ``models.T5`` from a transformers ``T5Model`` /
    ``T5ForConditionalGeneration`` (t5 relu or v1.1 gated-gelu): the same
    layout renamed, each stack's layer-0 relative-attention-bias table
    mapped."""
    from ..models import T5, T5Config
    hc = hf_model.config
    ff = hc.feed_forward_proj
    if ff not in ("relu", "gated-gelu"):
        raise ValueError(f"unsupported feed_forward_proj {ff!r}")
    cfg = T5Config(
        vocab_size=hc.vocab_size, d_model=hc.d_model, d_kv=hc.d_kv,
        d_ff=hc.d_ff, num_layers=hc.num_layers,
        num_decoder_layers=hc.num_decoder_layers, num_heads=hc.num_heads,
        relative_attention_num_buckets=hc.relative_attention_num_buckets,
        relative_attention_max_distance=hc.relative_attention_max_distance,
        layer_norm_epsilon=hc.layer_norm_epsilon,
        dropout_rate=hc.dropout_rate, feed_forward_proj=ff,
        tie_word_embeddings=hc.tie_word_embeddings,
        decoder_start_token_id=hc.decoder_start_token_id or 0)
    src = hf_model.state_dict()
    sd = {"shared.weight": src["shared.weight"],
          "enc_norm.weight": src["encoder.final_layer_norm.weight"],
          "dec_norm.weight": src["decoder.final_layer_norm.weight"]}
    ffn = ("wi_0", "wi_1", "wo") if ff == "gated-gelu" else ("wi", "wo")

    def attn(ours, theirs, with_table):
        for n in ("q", "k", "v", "o"):
            sd[f"{ours}.{n}.weight"] = src[f"{theirs}.{n}.weight"]
        if with_table:
            sd[f"{ours}.relative_attention_bias.weight"] = src[
                f"{theirs}.relative_attention_bias.weight"]

    def ln_ff(ours, theirs, j):
        sd[f"{ours}.ln_ff.weight"] = src[f"{theirs}.layer.{j}.layer_norm.weight"]
        for n in ffn:
            sd[f"{ours}.ff.{n}.weight"] = src[
                f"{theirs}.layer.{j}.DenseReluDense.{n}.weight"]

    for i in range(hc.num_layers):
        ours, b = f"enc_blocks.{i}", f"encoder.block.{i}"
        sd[f"{ours}.ln_attn.weight"] = src[f"{b}.layer.0.layer_norm.weight"]
        attn(f"{ours}.attn", f"{b}.layer.0.SelfAttention", i == 0)
        ln_ff(ours, b, 1)
    for i in range(hc.num_decoder_layers):
        ours, b = f"dec_blocks.{i}", f"decoder.block.{i}"
        sd[f"{ours}.ln_self.weight"] = src[f"{b}.layer.0.layer_norm.weight"]
        attn(f"{ours}.self_attn", f"{b}.layer.0.SelfAttention", i == 0)
        sd[f"{ours}.ln_cross.weight"] = src[f"{b}.layer.1.layer_norm.weight"]
        attn(f"{ours}.cross_attn", f"{b}.layer.1.EncDecAttention", False)
        ln_ff(ours, b, 2)
    if not hc.tie_word_embeddings:
        sd["lm_head.weight"] = (src["lm_head.weight"]
                                if "lm_head.weight" in src
                                else torch.zeros((hc.vocab_size,
                                                  hc.d_model)))
    return _materialize(lambda d: T5(cfg, device=d), sd, device)
