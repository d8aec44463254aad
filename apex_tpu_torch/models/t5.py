"""T5 encoder-decoder (Raffel et al.).

Counterpart of ``apex_tpu/models/t5.py``, HF's T5 layer for layer:

- T5's "LayerNorm" is RMS (no mean, no bias): ``models.llama.RMSNorm``;
- attention is unscaled (no 1/sqrt(d_kv)) with a decoupled ``d_kv``, and
  runs dense in torch ops: fp32 scores, plus the position bias and the
  additive -1e9 masks, softmax, then back to the activations' dtype
  (never the flash route: it takes no additive bias);
- a learned relative-position bias (bucketed, 32 buckets out to distance
  128) lives in layer 0 of each stack and serves every layer of it:
  bidirectional buckets in the encoder, causal in the decoder;
- the feed-forward is relu (t5) or gated-gelu (t5 v1.1);
- with tied embeddings the decoder output is scaled by ``d_model ** -0.5``
  (rounded to the activations' dtype) before the LM head.

Parameter names are the JAX package's tree paths (``shared.weight``,
``enc_blocks.0.attn.relative_attention_bias.weight``, ...), so
``utils.jax_interop`` carries weights both ways.  ``dropout_rate`` is
stored and not applied, as in the JAX package.

Decoding: ``generate`` runs the encoder once, computes each layer's
cross-attention K/V once and walks a (B, H, S, d_kv) self-attention
cache, written in place.  The serving contract (``init_seq2seq_state``,
``seed_slot_seq2seq``, ``decode_step_rows``) keeps per-slot state in
static buffers, written in place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import nn
from .._device import resolve_device
from ..nn import functional as F
from .gpt import head_table_t
from .llama import RMSNorm

__all__ = ["T5Config", "T5"]


class T5Config:
    def __init__(self, vocab_size=32128, d_model=512, d_kv=64,
                 d_ff=2048, num_layers=6, num_decoder_layers=None,
                 num_heads=8, relative_attention_num_buckets=32,
                 relative_attention_max_distance=128,
                 layer_norm_epsilon=1e-6, dropout_rate=0.1,
                 feed_forward_proj="relu", tie_word_embeddings=True,
                 decoder_start_token_id=0, max_length=512):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.d_kv = d_kv
        self.d_ff = d_ff
        self.num_layers = num_layers
        self.num_decoder_layers = (num_decoder_layers
                                   if num_decoder_layers is not None
                                   else num_layers)
        self.num_heads = num_heads
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = \
            relative_attention_max_distance
        self.layer_norm_epsilon = layer_norm_epsilon
        self.dropout_rate = dropout_rate
        if feed_forward_proj not in ("relu", "gated-gelu"):
            raise ValueError(f"feed_forward_proj={feed_forward_proj!r} not "
                             f"in ('relu', 'gated-gelu')")
        self.feed_forward_proj = feed_forward_proj
        self.tie_word_embeddings = tie_word_embeddings
        self.decoder_start_token_id = decoder_start_token_id
        self.max_length = max_length        # decode buffer bound


# bucket of each distance n in [0, len), by (buckets, max_distance, device)
_BUCKET_TABLES: Dict[tuple, torch.Tensor] = {}


def _bucket_table(num_buckets: int, max_distance: int,
                  device) -> torch.Tensor:
    """The one-sided bucket of every distance n in [0, N], N = max(
    max_distance, num_buckets // 2), HF's formula in fp32 as the JAX
    package evaluates it: exact below max_exact, then max_exact +
    trunc(log(n / max_exact + 1e-20) / log(max_distance / max_exact) *
    (num_buckets - max_exact)), capped at num_buckets - 1 (which every n
    >= max_distance reaches).  Computed on the CPU once, so every device
    reads the same buckets; kept on ``device`` (a captured step must not
    copy it there)."""
    key = (num_buckets, max_distance, str(device))
    table = _BUCKET_TABLES.get(key)
    if table is None:
        max_exact = num_buckets // 2
        n = torch.arange(max(max_distance, max_exact) + 1,
                         dtype=torch.int64)
        # the divisor is the log of a Python float in fp32, as jnp.log
        # evaluates it
        div = torch.log(torch.tensor(max_distance / max_exact,
                                     dtype=torch.float32))
        large = max_exact + (torch.log(n.float() / max_exact + 1e-20) / div
                             * (num_buckets - max_exact)).to(torch.int32)
        large = torch.clamp(large, max=num_buckets - 1).to(torch.int64)
        table = torch.where(n < max_exact, n, large).to(device)
        _BUCKET_TABLES[key] = table
    return table


def _relative_position_bucket(relative_position: torch.Tensor,
                              bidirectional: bool, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """HF T5's bucketing (``modeling_t5.py``): half the buckets for exact
    small offsets, the rest log-spaced out to ``max_distance``; the
    bidirectional form gives keys after the query the upper half."""
    n = -relative_position.long()
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + torch.where(n < 0, num_buckets, 0)
        n = n.abs()
    else:
        n = torch.clamp(n, min=0)
    table = _bucket_table(num_buckets, max_distance, n.device)
    return ret + table[torch.clamp(n, max=table.shape[0] - 1)]


def _neg(mask01: torch.Tensor) -> torch.Tensor:
    """(B, T) 1 = keep -> additive (B, 1, 1, T), -1e9 at the holes."""
    return (1.0 - mask01.float())[:, None, None, :] * -1e9


def _attend(q, k, v, bias, mask, out_dtype):
    """Unscaled attention of (B, H, Tq, d) q over (B, H, Tk, d) k, v: fp32
    scores plus ``bias`` and ``mask`` (additive, None to skip), softmax,
    cast to ``out_dtype`` before the product with v."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(out_dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(out_dtype))


class T5Attention(torch.nn.Module):
    """Unscaled multi-head attention with a decoupled d_kv; layer 0 of a
    stack owns the shared relative-position bias table."""

    def __init__(self, cfg: T5Config, has_bias_table: bool, *, device,
                 generator):
        super().__init__()
        self.H = cfg.num_heads
        self.dkv = cfg.d_kv
        inner = self.H * self.dkv
        kw = dict(bias=False, device=device, generator=generator)
        self.q = nn.Linear(cfg.d_model, inner, **kw)
        self.k = nn.Linear(cfg.d_model, inner, **kw)
        self.v = nn.Linear(cfg.d_model, inner, **kw)
        self.o = nn.Linear(inner, cfg.d_model, **kw)
        self.has_bias_table = has_bias_table
        self.nbuckets = cfg.relative_attention_num_buckets
        self.maxdist = cfg.relative_attention_max_distance
        if has_bias_table:
            self.relative_attention_bias = nn.Embedding(
                self.nbuckets, self.H, device=device, generator=generator)

    def position_bias(self, q_pos, k_pos, bidirectional: bool):
        """(1, H, Tq, Tk) additive bias from the layer-0 table."""
        rel = k_pos[None, :] - q_pos[:, None]
        buckets = _relative_position_bucket(rel, bidirectional,
                                            self.nbuckets, self.maxdist)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def heads(self, x, B, T):
        return x.reshape(B, T, self.H, self.dkv).movedim(2, 1)

    def merge_heads(self, ctx):
        B, _, T, _ = ctx.shape
        return ctx.movedim(1, 2).reshape(B, T, self.H * self.dkv)

    def forward(self, x, kv, mask, position_bias):
        """``kv``: x for self-attention, the encoder states for
        cross-attention; ``mask`` and ``position_bias`` additive,
        broadcasting to (B, H, Tq, Tk), or None."""
        B, Tq, _ = x.shape
        Tk = kv.shape[1]
        q = self.heads(self.q(x), B, Tq)
        k = self.heads(self.k(kv), B, Tk)
        v = self.heads(self.v(kv), B, Tk)
        return self.o(self.merge_heads(
            _attend(q, k, v, position_bias, mask, x.dtype)))


class T5FF(torch.nn.Module):
    def __init__(self, cfg: T5Config, *, device, generator):
        super().__init__()
        kw = dict(bias=False, device=device, generator=generator)
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x):
        if self.gated:
            h = F.gelu(self.wi_0(x)) * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5EncoderBlock(torch.nn.Module):
    def __init__(self, cfg: T5Config, first: bool, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        eps = cfg.layer_norm_epsilon
        self.ln_attn = RMSNorm(cfg.d_model, eps, device=device)
        self.attn = T5Attention(cfg, first, **kw)
        self.ln_ff = RMSNorm(cfg.d_model, eps, device=device)
        self.ff = T5FF(cfg, **kw)

    def forward(self, x, mask, position_bias):
        h = self.ln_attn(x)
        x = x + self.attn(h, h, mask, position_bias)
        return x + self.ff(self.ln_ff(x))


class T5DecoderBlock(torch.nn.Module):
    def __init__(self, cfg: T5Config, first: bool, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        eps = cfg.layer_norm_epsilon
        self.ln_self = RMSNorm(cfg.d_model, eps, device=device)
        self.self_attn = T5Attention(cfg, first, **kw)
        self.ln_cross = RMSNorm(cfg.d_model, eps, device=device)
        self.cross_attn = T5Attention(cfg, False, **kw)
        self.ln_ff = RMSNorm(cfg.d_model, eps, device=device)
        self.ff = T5FF(cfg, **kw)

    def forward(self, x, enc, self_mask, cross_mask, position_bias):
        h = self.ln_self(x)
        x = x + self.self_attn(h, h, self_mask, position_bias)
        x = x + self.cross_attn(self.ln_cross(x), enc, cross_mask, None)
        return x + self.ff(self.ln_ff(x))

    def step(self, x, layer_cache, pos, key_mask, bias, cross_k, cross_v,
             cross_mask):
        """One decoder token a row (B, 1, E): its self-attention K/V
        written into ``layer_cache`` at ``pos`` (an int, or (B,) per row)
        in place, attention over the cache (``bias`` and ``key_mask``
        additive) and over the precomputed cross K/V."""
        B = x.shape[0]
        sa = self.self_attn
        h = self.ln_self(x)
        q = sa.heads(sa.q(h), B, 1)
        k1 = sa.heads(sa.k(h), B, 1)
        v1 = sa.heads(sa.v(h), B, 1)
        ck, cv = layer_cache["k"], layer_cache["v"]
        if isinstance(pos, torch.Tensor):
            rows = torch.arange(B, device=x.device)
            # a row past the cache's end (a serving engine's finished
            # slot) writes its last entry, as the JAX package's clamped
            # dynamic_update_slice does
            wpos = torch.clamp(pos, max=ck.shape[2] - 1)
            ck[rows, :, wpos] = k1[:, :, 0].to(ck.dtype)
            cv[rows, :, wpos] = v1[:, :, 0].to(cv.dtype)
        else:
            ck[:, :, pos] = k1[:, :, 0].to(ck.dtype)
            cv[:, :, pos] = v1[:, :, 0].to(cv.dtype)
        x = x + sa.o(sa.merge_heads(_attend(q, ck, cv, bias, key_mask,
                                            x.dtype)))
        ca = self.cross_attn
        qc = ca.heads(ca.q(self.ln_cross(x)), B, 1)
        x = x + ca.o(ca.merge_heads(_attend(qc, cross_k, cross_v, None,
                                            cross_mask, x.dtype)))
        return x + self.ff(self.ln_ff(x))


class T5(torch.nn.Module):
    def __init__(self, cfg: T5Config, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.enc_blocks = torch.nn.ModuleList([
            T5EncoderBlock(cfg, i == 0, **kw)
            for i in range(cfg.num_layers)])
        self.enc_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                device=device)
        self.dec_blocks = torch.nn.ModuleList([
            T5DecoderBlock(cfg, i == 0, **kw)
            for i in range(cfg.num_decoder_layers)])
        self.dec_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                device=device)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size,
                                     bias=False, **kw)

    # -- encoder -----------------------------------------------------------
    def encode(self, input_ids, attention_mask=None):
        T = input_ids.shape[1]
        x = self.shared(input_ids)
        mask = None if attention_mask is None else _neg(attention_mask)
        pos = torch.arange(T, device=input_ids.device)
        bias = self.enc_blocks[0].attn.position_bias(pos, pos,
                                                     bidirectional=True)
        for blk in self.enc_blocks:
            x = blk(x, mask, bias)
        return self.enc_norm(x)

    # -- decoder (the whole sequence: training and scoring) ----------------
    def _decode_hidden_full(self, dec_ids, enc, enc_mask):
        T = dec_ids.shape[1]
        x = self.shared(dec_ids)
        ar = torch.arange(T, device=dec_ids.device)
        causal = torch.where(ar[None, :] <= ar[:, None], 0.0,
                             -1e9)[None, None]
        cross = None if enc_mask is None else _neg(enc_mask)
        bias = self.dec_blocks[0].self_attn.position_bias(
            ar, ar, bidirectional=False)
        for blk in self.dec_blocks:
            x = blk(x, enc, causal, cross, bias)
        return self.dec_norm(x)

    def _head(self, x):
        if self.cfg.tie_word_embeddings:
            # HF's tied head scales the decoder output, by the scalar
            # rounded to the activations' dtype
            s = torch.tensor(self.cfg.d_model ** -0.5, dtype=x.dtype)
            x = x * float(s)
            table = self.shared.weight
        else:
            table = self.lm_head.weight
        return F.matmul(x, head_table_t(table, x.dtype))

    def forward(self, input_ids, decoder_input_ids, attention_mask=None):
        enc = self.encode(input_ids, attention_mask)
        x = self._decode_hidden_full(decoder_input_ids, enc, attention_mask)
        return self._head(x)

    def loss(self, input_ids, labels, attention_mask=None,
             ignore_index: int = -100):
        """Teacher-forced cross-entropy: the decoder's inputs are the
        labels shifted right behind ``decoder_start_token_id`` (HF's
        ``_shift_right``); log_softmax in fp32."""
        start = torch.full((labels.shape[0], 1),
                           self.cfg.decoder_start_token_id,
                           dtype=labels.dtype, device=labels.device)
        safe_in = torch.where(labels == ignore_index, 0, labels)
        dec_in = torch.cat([start, safe_in[:, :-1]], dim=1)
        logits = self.forward(input_ids, dec_in, attention_mask)
        valid = labels != ignore_index
        safe = torch.where(valid, labels, 0)
        logp = F.log_softmax(logits.float(), axis=-1)
        nll = -torch.gather(logp, -1, safe.long()[..., None])[..., 0]
        return (nll * valid).sum() / valid.sum().clamp_min(1)

    # -- cached greedy generation ------------------------------------------
    def _cross_kv(self, enc):
        """Each decoder layer's cross-attention K and V (B, H, Tk, d_kv)
        of the encoder states."""
        B, Tk, _ = enc.shape
        out = []
        for blk in self.dec_blocks:
            ca = blk.cross_attn
            out.append((ca.heads(ca.k(enc), B, Tk),
                        ca.heads(ca.v(enc), B, Tk)))
        return out

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int, attention_mask=None):
        """Greedy decoding from ``decoder_start_token_id``: the encoder
        once, each layer's cross K/V once, the decoder's self-attention
        over a (B, H, S, d_kv) cache.  Returns the (B, max_new_tokens)
        generated ids (trimming at an EOS is the tokenizer's job)."""
        cfg = self.cfg
        B = input_ids.shape[0]
        S = max_new_tokens
        dev = input_ids.device
        enc = self.encode(input_ids, attention_mask)
        cross_mask = None if attention_mask is None else _neg(attention_mask)
        cross_kv = self._cross_kv(enc)
        cache = [{"k": enc.new_zeros((B, cfg.num_heads, S, cfg.d_kv)),
                  "v": enc.new_zeros((B, cfg.num_heads, S, cfg.d_kv))}
                 for _ in self.dec_blocks]
        b0 = self.dec_blocks[0].self_attn
        keys = torch.arange(S, device=dev)
        out = torch.zeros((B, S), dtype=torch.int64, device=dev)
        tok = torch.full((B,), cfg.decoder_start_token_id, dtype=torch.int64,
                         device=dev)
        for t in range(S):
            x = self.shared(tok[:, None])
            # the self-attention bias row of query t over keys 0..S-1
            bias = b0.position_bias(keys[t:t + 1], keys, bidirectional=False)
            key_mask = torch.where(keys <= t, 0.0, -1e9)[None, None, None, :]
            for blk, layer, (ck, cv) in zip(self.dec_blocks, cache,
                                            cross_kv):
                x = blk.step(x, layer, t, key_mask, bias, ck, cv, cross_mask)
            logits = self._head(self.dec_norm(x))[:, 0]
            tok = torch.argmax(logits, dim=-1)
            out[:, t] = tok
        return out

    # -- the slot contract of a seq2seq serving engine ---------------------
    def init_seq2seq_state(self, slots: int, src_len: int, dec_len: int,
                           dtype=torch.float32):
        """Per-slot serving state, static buffers: each layer's
        cross-attention K/V from the slot's encoder pass (``"cross"``),
        the decoder's self-attention cache (``"dec"``), keyed by str layer
        index, and each slot's source mask (``"src_mask"``)."""
        cfg = self.cfg
        dev = self.shared.weight.device

        def kv(length):
            shape = (slots, cfg.num_heads, length, cfg.d_kv)
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}

        n = cfg.num_decoder_layers
        return {"cross": {str(i): kv(src_len) for i in range(n)},
                "dec": {str(i): kv(dec_len) for i in range(n)},
                "src_mask": torch.zeros((slots, src_len), dtype=torch.float32,
                                        device=dev)}

    @torch.no_grad()
    def seed_slot_seq2seq(self, state, slot, src_row, n_src):
        """Run the encoder for one request (``src_row`` (src_len,), valid
        length ``n_src``) and write its cross K/V and source mask into
        ``slot``; the slot's decoder cache rows go to zero.  In place;
        returns ``state``."""
        src_len = src_row.shape[0]
        mask01 = (torch.arange(src_len, device=src_row.device)
                  < n_src).float()
        enc = self.encode(src_row[None, :], mask01[None, :])
        state["src_mask"][slot] = mask01
        for i, (k, v) in enumerate(self._cross_kv(enc)):
            layer, dlayer = state["cross"][str(i)], state["dec"][str(i)]
            layer["k"][slot] = k[0].to(layer["k"].dtype)
            layer["v"][slot] = v[0].to(layer["v"].dtype)
            for buf in (dlayer["k"], dlayer["v"]):
                if isinstance(slot, torch.Tensor):
                    # a device index (a captured admission): no host value
                    buf.index_fill_(0, slot.reshape(-1), 0)
                else:
                    buf[slot] = 0
        return state

    def _row_bias(self, pos, dec_len: int):
        """The decoder's self-attention bias a row: query at ``pos[b]``
        over keys 0..dec_len-1 -> (B, H, 1, dec_len)."""
        sa = self.dec_blocks[0].self_attn
        rel = torch.arange(dec_len, device=pos.device)[None, :] - pos[:, None]
        buckets = _relative_position_bucket(rel, False, sa.nbuckets,
                                            sa.maxdist)
        return sa.relative_attention_bias(buckets).permute(0, 2, 1)[:, :,
                                                                   None, :]

    @torch.no_grad()
    def decode_step_rows(self, tok, pos, state):
        """One decoder step at per-row positions: ``tok`` (B,) feeds
        position ``pos[b]`` of each slot; the decoder cache is written in
        place.  Returns (logits (B, V), state)."""
        dec_len = state["dec"]["0"]["k"].shape[2]
        pos = pos.long()
        x = self.shared(tok[:, None])
        bias = self._row_bias(pos, dec_len)
        key_mask = torch.where(
            torch.arange(dec_len, device=pos.device)[None, None, None, :]
            <= pos[:, None, None, None], 0.0, -1e9)
        cross_mask = ((1.0 - state["src_mask"]) * -1e9)[:, None, None, :]
        for i, blk in enumerate(self.dec_blocks):
            li = str(i)
            x = blk.step(x, state["dec"][li], pos, key_mask, bias,
                         state["cross"][li]["k"], state["cross"][li]["v"],
                         cross_mask)
        return self._head(self.dec_norm(x))[:, 0], state
