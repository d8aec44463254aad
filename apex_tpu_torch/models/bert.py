"""BERT encoder and pretraining heads (MLM + NSP), the model of the
FusedLayerNorm / FusedAdam benchmark configuration (BERT-base) and of
BERT-large.

Counterpart of ``apex_tpu/models/bert.py``: FusedLayerNorm (the LayerNorm
kernels), the attention dispatch of ``transformer.attention`` (the flash
kernels), and the chunked fused MLM head of ``nn.fused_xent``.  Parameter
names are the JAX package's tree paths (``bert.layer.0.attention.qkv.
weight``, ...), so ``utils.jax_interop`` carries weights both ways.  The
MLM decoder is tied to ``bert.word_embeddings.weight``: the same
parameter, registered once.

Weights come from ``generator`` (default: a CPU generator seeded 0).
Dropout, hidden and attention, is active in train mode
(``module.training``): its masks and the flash kernels' two seed words a
call are drawn on the device from ``dropout_generator`` (default: one on
``device`` seeded 0).  Under O1 the MLM logits go through
``nn.functional.matmul`` (whitelisted), while the fused head
(``linear_cross_entropy``) consults no policy and runs in its inputs'
dtype, fp32 there, as in the JAX package.  Tensor and sequence parallelism (``tp_axis``,
``sp_axis``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from .._device import resolve_device
from ..nn import functional as F
from ..normalization import FusedLayerNorm
from ..transformer.attention import dot_product_attention

__all__ = ["BertConfig", "BertModel", "BertForPretraining", "bert_base",
           "bert_large"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, layer_norm_eps=1e-12,
                 tp_axis=None, hidden_act="gelu_tanh", sp_axis=None,
                 head_chunk=8192):
        # head_chunk: vocab chunk of the fused MLM-head loss; None/0 takes
        # the dense logits + fp32 log_softmax path
        self.head_chunk = head_chunk
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.layer_norm_eps = layer_norm_eps
        if hidden_act not in ("gelu_tanh", "gelu_exact"):
            raise ValueError(f"hidden_act must be 'gelu_tanh' or "
                             f"'gelu_exact', got {hidden_act!r}")
        self.hidden_act = hidden_act
        if tp_axis is not None or sp_axis is not None:
            raise NotImplementedError(
                "tensor- and sequence-parallel BERT (tp_axis, sp_axis) are "
                "not ported yet: ROADMAP.md queue 1, item 12")


def bert_base():
    return BertConfig()


def bert_large():
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096)


class BertSelfAttention(torch.nn.Module):
    def __init__(self, cfg: BertConfig, *, device, generator,
                 dropout_generator):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.attention_probs_dropout_prob = cfg.attention_probs_dropout_prob
        self.dropout_generator = dropout_generator
        kw = dict(device=device, generator=generator)
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.out = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.drop = nn.Dropout(cfg.hidden_dropout_prob,
                               generator=dropout_generator)

    def forward(self, x, mask=None):
        B, T, E = x.shape
        qkv = self.qkv(x).reshape(B, T, 3, self.num_heads, self.head_dim)
        q, k, v = (qkv[:, :, i].movedim(2, 1) for i in range(3))
        ctx = dot_product_attention(
            q, k, v, mask, dropout_rate=self.attention_probs_dropout_prob,
            generator=self.dropout_generator if self.training else None)
        ctx = ctx.movedim(1, 2).reshape(B, T, E)
        return self.drop(self.out(ctx))


class BertLayer(torch.nn.Module):
    def __init__(self, cfg: BertConfig, *, device, generator,
                 dropout_generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.attention = BertSelfAttention(
            cfg, dropout_generator=dropout_generator, **kw)
        self.attention_ln = FusedLayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps,
                                           device=device)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                      **kw)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.output_ln = FusedLayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps, device=device)
        self.drop = nn.Dropout(cfg.hidden_dropout_prob,
                               generator=dropout_generator)
        self.gelu_approx = cfg.hidden_act != "gelu_exact"

    def forward(self, x, mask=None):
        x = self.attention_ln(x + self.attention(x, mask))
        h = F.gelu(self.intermediate(x), approximate=self.gelu_approx)
        h = self.drop(self.output(h))
        return self.output_ln(x + h)


class BertModel(torch.nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if dropout_generator is None:
            dropout_generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        # BERT's initializer_range = 0.02
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            init_std=0.02, **kw)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, init_std=0.02, **kw)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, init_std=0.02, **kw)
        self.embeddings_ln = FusedLayerNorm(cfg.hidden_size,
                                            eps=cfg.layer_norm_eps,
                                            device=device)
        self.layer = nn.ModuleList([
            BertLayer(cfg, dropout_generator=dropout_generator, **kw)
            for _ in range(cfg.num_hidden_layers)])
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        B, T = input_ids.shape
        if T > self.cfg.max_position_embeddings:
            raise ValueError(f"sequence length {T} exceeds "
                             f"max_position_embeddings "
                             f"{self.cfg.max_position_embeddings}")
        pos = torch.arange(T, device=input_ids.device)[None, :]
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        x = self.embeddings_ln(emb)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for layer in self.layer:
            x = layer(x, mask)
        return x, F.tanh(self.pooler(x[:, 0]))


class BertForPretraining(torch.nn.Module):
    """MLM + NSP heads; ``loss`` is the pretraining loss."""

    def __init__(self, cfg: BertConfig, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.bert = BertModel(cfg, device=device, generator=generator,
                              dropout_generator=dropout_generator)
        kw = dict(device=device, generator=generator)
        self.mlm_dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.mlm_ln = FusedLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                     device=device)
        self.nsp = nn.Linear(cfg.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h, pooled = self._mlm_hidden(input_ids, token_type_ids,
                                     attention_mask)
        # the decoder is the word-embedding table
        table = self.bert.word_embeddings.weight
        mlm_logits = F.matmul(h, table.t().to(h.dtype))
        return mlm_logits, self.nsp(pooled)

    def _mlm_hidden(self, input_ids, token_type_ids=None,
                    attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_ln(F.gelu(self.mlm_dense(seq),
                               approximate=self.cfg.hidden_act
                               != "gelu_exact"))
        return h, pooled

    def loss(self, input_ids, mlm_labels, nsp_labels, token_type_ids=None,
             attention_mask=None, ignore_index=-100):
        h, pooled = self._mlm_hidden(input_ids, token_type_ids,
                                     attention_mask)
        nsp_logits = self.nsp(pooled)
        valid = mlm_labels != ignore_index
        labels = torch.where(valid, mlm_labels, 0)
        table = self.bert.word_embeddings.weight
        if self.cfg.head_chunk:
            from ..nn.fused_xent import linear_cross_entropy
            B, T, H = h.shape
            nll = linear_cross_entropy(h.reshape(B * T, H), table,
                                       labels.reshape(-1),
                                       int(self.cfg.head_chunk)).reshape(B, T)
        else:
            logits = F.matmul(h, table.t().to(h.dtype))
            logp = F.log_softmax(logits.float(), axis=-1)
            nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        mlm_loss = (nll * valid).sum() / valid.sum().clamp_min(1)
        return mlm_loss + F.cross_entropy(nsp_logits, nsp_labels)
