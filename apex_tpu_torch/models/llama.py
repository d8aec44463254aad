"""Llama-family causal language model (RMSNorm + RoPE + SwiGLU + GQA), with
the knobs that make it Mistral, Qwen2, Gemma and GPT-NeoX.

Counterpart of ``apex_tpu/models/llama.py``: RMS pre-normalization
(plain torch ops, fp32 statistics), rotary embeddings in HF's
rotate-half convention, SwiGLU MLPs, grouped-query attention with the
compact KV cache, and the fused chunked LM-head loss.  Training attention
goes through ``transformer.attention``'s dispatch: the flash kernels
(K/V repeated to full heads) where the shape allows, the dense route for
a sliding window (its band is a per-pair mask) and for head dims above
128 (Gemma).  The knobs:

- ``sliding_window`` (Mistral): key j is visible to query i iff
  i - W < j <= i; training takes the dense banded path, decode applies
  the window in its cache read; ``rolling_cache`` keeps W slots.
- ``attention_bias`` (Qwen2): biases on the q/k/v projections.
- ``head_dim``, ``mlp_act="gelu_tanh"``, ``rms_unit_offset``,
  ``embed_scale`` (Gemma).
- ``norm_type="layernorm"`` (the LayerNorm kernels), ``parallel_residual``,
  ``rotary_pct``, ``mlp_type="gelu_mlp"``, ``attention_out_bias``
  (GPT-NeoX).

Parameter names are the JAX package's tree paths
(``layers.0.self_attn.q_proj.weight``, ...).  Weights come from
``generator`` (default: a CPU generator seeded 0).  Generation is
``generate_cached`` (``models.gpt``'s loop).  Tensor and sequence
parallelism (``tp_axis``, ``sp_axis``) and ``llama_params_to_tp`` are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from .._device import resolve_device
from ..nn import functional as F
from ..normalization import FusedLayerNorm
from ..transformer.attention import dot_product_attention
from . import _cache
from ._remat import _MODES, wrap_block
from .gpt import (_UNPORTED_PARALLEL, _as_query_axis, _generate_cached,
                  _init_cache, cached_attention, head_table_t, nll_table,
                  query_positions)

__all__ = ["LlamaConfig", "Llama", "RMSNorm", "apply_rope"]


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=2048, rms_norm_eps=1e-6,
                 rope_theta=10000.0, tie_word_embeddings=False,
                 head_chunk=8192, sp_axis=None, tp_axis=None,
                 remat=None, sliding_window=None, attention_bias=False,
                 head_dim=None, mlp_act="silu", rms_unit_offset=False,
                 embed_scale=False, norm_type="rmsnorm",
                 parallel_residual=False, rotary_pct=1.0,
                 mlp_type="swiglu", attention_out_bias=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = (num_key_value_heads
                                    if num_key_value_heads is not None
                                    else num_attention_heads)
        if (self.num_key_value_heads < 1
                or num_attention_heads % self.num_key_value_heads):
            raise ValueError(
                f"num_key_value_heads={self.num_key_value_heads} must be "
                f"a positive divisor of num_attention_heads="
                f"{num_attention_heads}")
        if hidden_size % num_attention_heads:
            raise ValueError("hidden_size must divide into heads")
        if tp_axis is not None or sp_axis is not None:
            raise NotImplementedError(_UNPORTED_PARALLEL)
        self.tp_axis = self.sp_axis = None
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        self.head_chunk = head_chunk
        if remat not in _MODES:
            raise ValueError(f"remat={remat!r} not in {_MODES}")
        self.remat = remat
        if sliding_window is not None and sliding_window < 1:
            raise ValueError(f"sliding_window={sliding_window} must be >= 1")
        self.sliding_window = sliding_window
        self.attention_bias = attention_bias
        self.head_dim = (head_dim if head_dim is not None
                         else hidden_size // num_attention_heads)
        if mlp_act not in ("silu", "gelu_tanh"):
            raise ValueError(f"mlp_act={mlp_act!r} not in "
                             f"('silu', 'gelu_tanh')")
        self.mlp_act = mlp_act
        self.rms_unit_offset = rms_unit_offset
        self.embed_scale = embed_scale
        if norm_type not in ("rmsnorm", "layernorm"):
            raise ValueError(f"norm_type={norm_type!r} not in "
                             f"('rmsnorm', 'layernorm')")
        self.norm_type = norm_type
        self.parallel_residual = parallel_residual
        if not 0.0 < rotary_pct <= 1.0:
            raise ValueError(f"rotary_pct={rotary_pct} not in (0, 1]")
        self.rotary_pct = rotary_pct
        if mlp_type not in ("swiglu", "gelu_mlp"):
            raise ValueError(f"mlp_type={mlp_type!r} not in "
                             f"('swiglu', 'gelu_mlp')")
        self.mlp_type = mlp_type
        self.attention_out_bias = attention_out_bias


class RMSNorm(torch.nn.Module):
    """x * rsqrt(mean(x^2) + eps) * w, statistics in fp32, output in the
    input's dtype; ``unit_offset`` scales by (1 + w) (Gemma)."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 unit_offset: bool = False, *, device=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.unit_offset = unit_offset
        self.weight = torch.nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        w = self.weight.float()
        if self.unit_offset:
            w = 1.0 + w
        return (y * w).to(x.dtype)


def _rope_cos_sin(pos: torch.Tensor, head_dim: int, theta: float):
    """HF-llama convention: inv_freq over the first D/2 dims, cos/sin tiled
    twice (rotate-half pairing, not interleaved); fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=pos.device) / head_dim))
    ang = pos.float()[..., None] * inv                  # (..., T, D/2)
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, pos, theta):
    """q: (B, H, T, D), k: (B, Hkv, T, D), pos: (B, T) or (T,)."""
    cos, sin = _rope_cos_sin(pos, q.shape[-1], theta)
    while cos.dim() < q.dim():                  # -> broadcast over heads
        cos, sin = cos.unsqueeze(-3), sin.unsqueeze(-3)

    def rot(x):
        xf = x.float()
        return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)

    return rot(q), rot(k)


class LlamaAttention(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, generator):
        super().__init__()
        self.H = cfg.num_attention_heads
        self.Hkv = cfg.num_key_value_heads
        self.D = cfg.head_dim
        self.theta = cfg.rope_theta
        self.window = cfg.sliding_window
        # partial rotary (GPT-NeoX): the first rot_dim dims rotate
        self.rot_dim = int(cfg.rotary_pct * self.D)
        E = cfg.hidden_size
        kw = dict(device=device, generator=generator)
        ab = cfg.attention_bias
        self.q_proj = nn.Linear(E, self.H * self.D, bias=ab, **kw)
        self.k_proj = nn.Linear(E, self.Hkv * self.D, bias=ab, **kw)
        self.v_proj = nn.Linear(E, self.Hkv * self.D, bias=ab, **kw)
        self.o_proj = nn.Linear(self.H * self.D, E,
                                bias=cfg.attention_out_bias, **kw)

    def _rope(self, q, k, pos):
        if self.rot_dim >= self.D:
            return apply_rope(q, k, pos, self.theta)
        rd = self.rot_dim
        q1, k1 = apply_rope(q[..., :rd], k[..., :rd], pos, self.theta)
        return (torch.cat([q1, q[..., rd:]], dim=-1),
                torch.cat([k1, k[..., rd:]], dim=-1))

    def _qkv(self, x, B, T):
        q = self.q_proj(x).reshape(B, T, self.H, self.D)
        k = self.k_proj(x).reshape(B, T, self.Hkv, self.D)
        v = self.v_proj(x).reshape(B, T, self.Hkv, self.D)
        return q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1)

    def _full_heads(self, k, v):
        if self.Hkv == self.H:
            return k, v
        rep = self.H // self.Hkv
        return (k.repeat_interleave(rep, dim=1),
                v.repeat_interleave(rep, dim=1))

    def _with_band(self, mask, T, device):
        """AND the sliding-window band (key j visible to query i iff j >
        i - W; the causal half is causal=True) into ``mask``."""
        if self.window is None:
            return mask
        ar = torch.arange(T, device=device)
        band = (ar[None, :] > ar[:, None] - self.window)[None, None]
        return band if mask is None else torch.logical_and(mask, band)

    def _attend(self, q, k, v, mask):
        B, _, T, _ = q.shape
        k, v = self._full_heads(k, v)
        ctx = dot_product_attention(q, k, v,
                                    self._with_band(mask, T, q.device),
                                    causal=True)
        return self.o_proj(ctx.movedim(1, 2).reshape(B, T, self.H * self.D))

    def forward(self, x, mask=None):
        B, T, _ = x.shape
        q, k, v = self._qkv(x, B, T)
        q, k = self._rope(q, k, torch.arange(T, device=x.device))
        return self._attend(q, k, v, mask)

    def prefill(self, x):
        """Full-sequence attention that also returns the compact post-RoPE
        K/V (B, Hkv, T, D) for cache seeding."""
        B, T, _ = x.shape
        q, k, v = self._qkv(x, B, T)
        q, k = self._rope(q, k, torch.arange(T, device=x.device))
        return self._attend(q, k, v, None), k, v

    def decode_chunk(self, x, pos, cache):
        """An L-token cached step at positions ``[pos, pos + L)`` (an int,
        or (B,) per row): the chunk's post-RoPE K/V written into ``cache``
        in place, each query attending to the keys at or before its
        position (within the window if set).  A cache exactly
        ``sliding_window`` wide is a rolling buffer (position p in slot p
        % W), which takes one token a step."""
        B, L, _ = x.shape
        S = cache["k"].shape[2]
        rolling = self.window is not None and S == self.window
        if rolling and L > 1:
            raise NotImplementedError(
                "decode_chunk over a rolling cache supports only L == 1 "
                "(engine ticks); use full-width caches for chunked "
                "verify/prefill")
        q, k, v = self._qkv(x, B, L)
        qpos = query_positions(pos, L, x.device)
        q, k = self._rope(q, k, qpos)
        _cache.write(cache, k, v, (pos % S) if rolling else pos)
        qpos = _as_query_axis(qpos)
        kpos = torch.arange(S, device=x.device)
        if rolling:
            # slot s holds absolute position q - ((q - s) mod W): always <=
            # q and > q - W, so only p_s >= 0 needs checking
            valid = (qpos - ((qpos - kpos) % S)) >= 0
        else:
            valid = kpos <= qpos
            if self.window is not None:
                valid = valid & (kpos > qpos - self.window)
        return self.o_proj(cached_attention(q, cache, valid, x.dtype)), cache

    def decode(self, x, pos, cache):
        """One token (B, 1, E) at position ``pos``."""
        return self.decode_chunk(x, pos, cache)


class LlamaMLP(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, generator):
        super().__init__()
        kw = dict(bias=False, device=device, generator=generator)
        self.act = cfg.mlp_act
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                   **kw)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   **kw)

    def forward(self, x):
        act = F.silu if self.act == "silu" else F.gelu
        return self.down_proj(act(self.gate_proj(x)) * self.up_proj(x))


class GeluMLP(torch.nn.Module):
    """GPT-NeoX's 2-layer MLP: dense_h_to_4h -> exact gelu ->
    dense_4h_to_h, with biases."""

    def __init__(self, cfg: LlamaConfig, *, device, generator):
        super().__init__()
        kw = dict(bias=True, device=device, generator=generator)
        self.dense_h_to_4h = nn.Linear(cfg.hidden_size,
                                       cfg.intermediate_size, **kw)
        self.dense_4h_to_h = nn.Linear(cfg.intermediate_size,
                                       cfg.hidden_size, **kw)

    def forward(self, x):
        return self.dense_4h_to_h(F.gelu_exact(self.dense_h_to_4h(x)))


def _make_norm(cfg, device):
    if cfg.norm_type == "layernorm":
        return FusedLayerNorm(cfg.hidden_size, eps=cfg.rms_norm_eps,
                              device=device)
    return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.rms_unit_offset,
                   device=device)


class LlamaBlock(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.input_layernorm = _make_norm(cfg, device)
        self.self_attn = LlamaAttention(cfg, **kw)
        self.post_attention_layernorm = _make_norm(cfg, device)
        self.mlp = (GeluMLP(cfg, **kw) if cfg.mlp_type == "gelu_mlp"
                    else LlamaMLP(cfg, **kw))
        self.parallel_residual = cfg.parallel_residual

    def _residual(self, x, a):
        if self.parallel_residual:      # NeoX: both norms see x
            return x + a + self.mlp(self.post_attention_layernorm(x))
        x = x + a
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, mask=None):
        return self._residual(x, self.self_attn(self.input_layernorm(x),
                                                mask))

    def prefill(self, x):
        a, k, v = self.self_attn.prefill(self.input_layernorm(x))
        return self._residual(x, a), k, v

    def decode_chunk(self, x, pos, cache):
        a, cache = self.self_attn.decode_chunk(self.input_layernorm(x), pos,
                                               cache)
        return self._residual(x, a), cache

    decode = decode_chunk


class Llama(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        # Llama's initializer_range = 0.02
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         init_std=0.02, **kw)
        self.layers = torch.nn.ModuleList([
            LlamaBlock(cfg, **kw) for _ in range(cfg.num_hidden_layers)])
        self.norm = _make_norm(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False, **kw)

    def _table(self):
        return (self.embed_tokens.weight if self.cfg.tie_word_embeddings
                else self.lm_head.weight)

    def _embed(self, tokens):
        x = self.embed_tokens(tokens)
        if self.cfg.embed_scale:
            # sqrt(hidden) rounded to the activations' dtype, as the JAX
            # package's scalar array of x.dtype
            s = torch.tensor(self.cfg.hidden_size ** 0.5, dtype=x.dtype)
            x = x * float(s)
        return x

    def _head(self, x):
        return F.matmul(x, head_table_t(self._table(), x.dtype))

    # -- training ------------------------------------------------------------
    def _backbone(self, input_ids, attention_mask=None):
        T = input_ids.shape[1]
        if T > self.cfg.max_position_embeddings:
            raise ValueError(f"sequence length {T} exceeds "
                             f"max_position_embeddings "
                             f"{self.cfg.max_position_embeddings}")
        x = self._embed(input_ids)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for blk in self.layers:
            x = wrap_block(blk, self.cfg.remat)(x, mask)
        return self.norm(x)

    def forward(self, input_ids, attention_mask=None):
        return self._head(self._backbone(input_ids, attention_mask))

    def _nll(self, x, safe_labels):
        """Per-position nll (B, T') through the head: fused chunked by
        default, dense with ``head_chunk=None``."""
        table = nll_table(self._table(), x.dtype)
        B, T, D = x.shape
        if self.cfg.head_chunk:
            from ..nn.fused_xent import linear_cross_entropy
            return linear_cross_entropy(
                x.reshape(B * T, D), table, safe_labels.reshape(-1),
                int(self.cfg.head_chunk)).reshape(B, T)
        logits = F.matmul(x, head_table_t(table, x.dtype))
        logp = F.log_softmax(logits.float(), axis=-1)
        return -torch.gather(logp, -1, safe_labels.long()[..., None])[..., 0]

    def loss(self, input_ids, attention_mask=None, ignore_index: int = -100):
        """Next-token cross-entropy (``GPT.loss``'s contract)."""
        labels = input_ids[:, 1:]
        if attention_mask is not None:
            labels = torch.where(attention_mask[:, 1:] != 0, labels,
                                 ignore_index)
        x = self._backbone(input_ids, attention_mask)[:, :-1]
        valid = labels != ignore_index
        nll = self._nll(x, torch.where(valid, labels, 0))
        return (nll * valid).sum() / valid.sum().clamp_min(1)

    # -- KV-cached decoding --------------------------------------------------
    def init_cache(self, batch_size: int, dtype=torch.float32,
                   rolling: bool = False):
        """Per-layer (B, Hkv, S, head_dim) buffers, S the maximum position
        or, with ``rolling`` (needs ``sliding_window``), the window."""
        cfg = self.cfg
        if rolling and cfg.sliding_window is None:
            raise ValueError("rolling cache requires sliding_window")
        width = (cfg.sliding_window if rolling
                 else cfg.max_position_embeddings)
        return _init_cache(cfg.num_hidden_layers,
                           (batch_size, cfg.num_key_value_heads, width,
                            cfg.head_dim), dtype,
                           self.embed_tokens.weight.device)

    def _decode_hidden(self, token, pos, cache):
        x = self._embed(token[:, None])
        for i, blk in enumerate(self.layers):
            x, _ = blk.decode(x, pos, cache[str(i)])
        return self.norm(x), cache

    @torch.no_grad()
    def decode_step(self, token, pos, cache):
        x, cache = self._decode_hidden(token, pos, cache)
        return self._head(x)[:, 0], cache

    @torch.no_grad()
    def prefill_cache(self, input_ids, cache=None, cache_dtype=None):
        """Seed every layer's cache with one full-buffer forward."""
        B, _ = input_ids.shape
        if cache is None:
            cache = self.init_cache(B, dtype=cache_dtype
                                    or self._table().dtype)
        x = self._embed(input_ids)
        for i, blk in enumerate(self.layers):
            x, k, v = blk.prefill(x)
            _cache.seed_layer(cache[str(i)], k, v)
        return cache

    @torch.no_grad()
    def decode_chunk(self, tokens, pos, cache):
        x = self._embed(tokens)
        for i, blk in enumerate(self.layers):
            x, _ = blk.decode_chunk(x, pos, cache[str(i)])
        return self.norm(x), cache

    @torch.no_grad()
    def generate_cached(self, input_ids, prompt_len, max_new_tokens: int,
                        temperature: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        cache_dtype=None, top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        prefill_mode: str = "chunked",
                        rolling_cache: bool = False,
                        min_p: Optional[float] = None,
                        repetition_penalty: float = 1.0):
        """Fixed-buffer KV-cached generation (``GPT.generate_cached``'s
        contract); ``rolling_cache`` (sliding-window models) keeps
        window-wide buffers and walks every position."""
        return _generate_cached(
            self, input_ids, prompt_len, max_new_tokens, temperature,
            generator, cache_dtype, top_k, top_p, prefill_mode, min_p,
            repetition_penalty, self._table().dtype,
            rolling_cache=rolling_cache)
