"""GPT-2-class causal language model.

Counterpart of ``apex_tpu/models/gpt.py``: a pre-LN decoder with causal
attention through ``transformer.attention``'s dispatch (the flash kernels
in training and in the full-buffer prefill), FusedLayerNorm (the
LayerNorm kernels), learned positions, the weight-tied LM head and the
chunked fused head loss (``nn.fused_xent``).  Grouped-query attention
(``n_kv_head``) keeps the fused ``[q; k; v]`` projection rows; the
training path repeats K/V to full heads before the flash route, the
decode path attends against the compact (B, n_kv_head, S, D) cache.
Parameter names are the JAX package's tree paths (``h.0.attn.qkv.weight``,
...), so ``utils.jax_interop`` carries weights both ways.

Weights come from ``generator`` (default: a CPU generator seeded 0);
dropout (embeddings, attention probabilities on the flash route, the
residual branches) is active in train mode and draws from
``dropout_generator`` (default: one on ``device`` seeded 0).  ``remat``
wraps each block (``models._remat``).

Generation is eval-mode and runs under ``torch.no_grad``.  ``generate``
re-runs the whole fixed (B, block_size) buffer a token;
``generate_cached`` writes K/V into static per-layer buffers in place
(bf16 or the int8 cache of ``models._cache``), seeds them with one
full-buffer forward (``prefill_mode="chunked"``) or walks the prompt
(``"step"``), and reads the loop's bounds from the host once, before the
loop.  The weights may be weight-only int8 (``quantization.
quantize_for_decode``): the head dequantizes its table.  Tensor and
sequence parallelism (``tp_axis``, ``sp_axis``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import nn
from .._device import resolve_device
from ..nn import functional as F
from ..normalization import FusedLayerNorm
from ..quantization import QTensor
from ..transformer.attention import dot_product_attention
from . import _cache, sampling
from ._remat import _MODES, wrap_block

__all__ = ["GPTConfig", "GPT", "gpt2_small", "gpt2_medium"]

_UNPORTED_PARALLEL = ("tensor- and sequence-parallel decoders (tp_axis, "
                      "sp_axis) are not ported yet: ROADMAP.md queue 1, "
                      "item 6")


def head_table_t(table, dtype) -> torch.Tensor:
    """``table.T`` in ``dtype`` for an LM head (``x @ table.T``): a
    weight-only int8 ``quantization.QTensor`` dequantizes in its logical
    dtype first, as the JAX package's ``table.T.astype(x.dtype)``."""
    if isinstance(table, QTensor):
        table = table.dequant()
    return table.t().to(dtype)


def nll_table(table, dtype) -> torch.Tensor:
    """The head table of a loss: a ``QTensor`` dequantized to ``dtype``
    (the fused chunked head slices it), as the JAX package does."""
    return table.dequant(dtype) if isinstance(table, QTensor) else table


class GPTConfig:
    def __init__(self, vocab_size=50257, block_size=1024, n_layer=12,
                 n_head=12, n_embd=768, dropout=0.1,
                 layer_norm_eps=1e-5, tp_axis=None, sp_axis=None,
                 head_chunk=8192, n_kv_head=None, remat=None):
        # head_chunk: vocab chunk of the fused LM-head loss; None/0 takes
        # the dense logits + fp32 log_softmax path
        self.head_chunk = head_chunk
        self.vocab_size = vocab_size
        self.block_size = block_size
        self.n_layer = n_layer
        self.n_head = n_head
        self.n_embd = n_embd
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.n_kv_head = n_kv_head if n_kv_head is not None else n_head
        if self.n_kv_head < 1 or n_head % self.n_kv_head:
            raise ValueError(f"n_kv_head={self.n_kv_head} must be a "
                             f"positive divisor of n_head={n_head}")
        if remat not in _MODES:
            raise ValueError(f"remat={remat!r} not in {_MODES}")
        self.remat = remat
        if tp_axis is not None or sp_axis is not None:
            raise NotImplementedError(_UNPORTED_PARALLEL)
        self.tp_axis = self.sp_axis = None


def gpt2_small():
    return GPTConfig()


def gpt2_medium():
    return GPTConfig(n_layer=24, n_head=16, n_embd=1024)


def cached_attention(q: torch.Tensor, layer_cache: Dict[str, torch.Tensor],
                     valid: torch.Tensor, out_dtype) -> torch.Tensor:
    """Grouped attention of ``q`` (B, H, L, D) against one layer's compact
    (B, Hkv, S, D) cache, in fp32: query heads reshape into (Hkv, group)
    and share each KV head.  ``valid`` broadcasts to (B, Hkv, G, L, S).
    Returns (B, L, H * D) in ``out_dtype``."""
    B, H, L, D = q.shape
    kf, vf = _cache.read(layer_cache)
    Hkv = kf.shape[1]
    qg = q.float().reshape(B, Hkv, H // Hkv, L, D)
    scores = torch.einsum("bkgld,bksd->bkgls", qg, kf) * (1.0 / (D ** 0.5))
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgls,bksd->bkgld", probs, vf).to(out_dtype)
    return ctx.permute(0, 3, 1, 2, 4).reshape(B, L, H * D)


def query_positions(pos, L: int, device) -> torch.Tensor:
    """Positions of an L-token chunk: (L,) from an int or 0-d ``pos`` (the
    same for every row), (B, L) from a (B,) ``pos``."""
    ar = torch.arange(L, device=device)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device)
        return pos[:, None] + ar if pos.dim() == 1 else pos + ar
    return ar + pos


def _as_query_axis(qpos: torch.Tensor) -> torch.Tensor:
    """Query positions (L,) or (B, L) shaped to broadcast against
    (B, Hkv, G, L, S) scores: (L, 1) or (B, 1, 1, L, 1)."""
    if qpos.dim() == 2:
        return qpos[:, None, None, :, None]
    return qpos[:, None]


class GPTSelfAttention(torch.nn.Module):
    """Causal self-attention over the fused [q; k; v] projection."""

    def __init__(self, cfg: GPTConfig, *, device, generator,
                 dropout_generator):
        super().__init__()
        self.n_head = cfg.n_head
        self.n_kv = cfg.n_kv_head
        self.head_dim = cfg.n_embd // cfg.n_head
        self.dropout = cfg.dropout
        self.dropout_generator = dropout_generator
        kw = dict(device=device, generator=generator)
        self.qkv = nn.Linear(cfg.n_embd,
                             (cfg.n_head + 2 * self.n_kv) * self.head_dim,
                             **kw)
        self.out = nn.Linear(cfg.n_embd, cfg.n_embd, **kw)
        self.drop = nn.Dropout(cfg.dropout, generator=dropout_generator)

    def _split_qkv(self, fused, B, T):
        """(B, T, (H+2Hkv)*D) -> q (B,H,T,D), k/v (B,Hkv,T,D)."""
        H, Hkv, D = self.n_head, self.n_kv, self.head_dim
        q = fused[..., :H * D].reshape(B, T, H, D)
        k = fused[..., H * D:(H + Hkv) * D].reshape(B, T, Hkv, D)
        v = fused[..., (H + Hkv) * D:].reshape(B, T, Hkv, D)
        return q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1)

    def _full_heads(self, k, v):
        """K/V repeated to full heads, so the flash kernels see MHA."""
        if self.n_kv == self.n_head:
            return k, v
        rep = self.n_head // self.n_kv
        return (k.repeat_interleave(rep, dim=1),
                v.repeat_interleave(rep, dim=1))

    def forward(self, x, mask=None):
        B, T, E = x.shape
        q, k, v = self._split_qkv(self.qkv(x), B, T)
        k, v = self._full_heads(k, v)
        ctx = dot_product_attention(
            q, k, v, mask, causal=True, dropout_rate=self.dropout,
            generator=self.dropout_generator if self.training else None)
        ctx = ctx.movedim(1, 2).reshape(B, T, E)
        return self.drop(self.out(ctx))

    def prefill(self, x):
        """Full-sequence attention that also returns the compact K/V
        (B, Hkv, T, D) for cache seeding; no dropout."""
        B, T, E = x.shape
        q, kc, vc = self._split_qkv(self.qkv(x), B, T)
        k, v = self._full_heads(kc, vc)
        ctx = dot_product_attention(q, k, v, None, causal=True)
        return self.out(ctx.movedim(1, 2).reshape(B, T, E)), kc, vc

    def decode_chunk(self, x, pos, cache):
        """An L-token cached step at positions ``[pos, pos + L)`` (``pos``
        an int, or (B,) per row): writes the chunk's K/V into ``cache`` in
        place and attends each query to the keys at or before its own
        position.  Returns (out (B, L, E), cache)."""
        B, L, E = x.shape
        S = cache["k"].shape[2]
        q, k, v = self._split_qkv(self.qkv(x), B, L)
        _cache.write(cache, k, v, pos)
        qpos = _as_query_axis(query_positions(pos, L, x.device))
        valid = torch.arange(S, device=x.device) <= qpos
        return self.out(cached_attention(q, cache, valid, x.dtype)), cache

    def decode(self, x, pos, cache):
        """One token (B, 1, E) at position ``pos`` against the cache."""
        return self.decode_chunk(x, pos, cache)


class GPTBlock(torch.nn.Module):
    """Pre-LN decoder block (GPT-2 ordering: x + attn(ln(x)))."""

    def __init__(self, cfg: GPTConfig, *, device, generator,
                 dropout_generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln_1 = FusedLayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps,
                                   device=device)
        self.attn = GPTSelfAttention(cfg, dropout_generator=dropout_generator,
                                     **kw)
        self.ln_2 = FusedLayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps,
                                   device=device)
        self.fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, **kw)
        self.proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, **kw)
        self.drop = nn.Dropout(cfg.dropout, generator=dropout_generator)

    def _mlp(self, x):
        return self.proj(F.gelu(self.fc(self.ln_2(x))))

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.drop(self._mlp(x))

    def prefill(self, x):
        a, k, v = self.attn.prefill(self.ln_1(x))
        x = x + a
        return x + self._mlp(x), k, v

    def decode_chunk(self, x, pos, cache):
        a, cache = self.attn.decode_chunk(self.ln_1(x), pos, cache)
        x = x + a
        return x + self._mlp(x), cache

    decode = decode_chunk


class GPT(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None,
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
        # GPT-2's initializer_range (the tied head would otherwise start
        # with ~9x-hot logits)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, init_std=0.02,
                                **kw)
        self.wpe = nn.Embedding(cfg.block_size, cfg.n_embd, init_std=0.02,
                                **kw)
        self.h = torch.nn.ModuleList([
            GPTBlock(cfg, dropout_generator=dropout_generator, **kw)
            for _ in range(cfg.n_layer)])
        self.ln_f = FusedLayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps,
                                   device=device)
        self.drop = nn.Dropout(cfg.dropout, generator=dropout_generator)

    # -- training ------------------------------------------------------------
    def _backbone(self, input_ids, attention_mask=None):
        """Pre-head hidden states (B, T, E)."""
        B, T = input_ids.shape
        if T > self.cfg.block_size:
            raise ValueError(f"sequence length {T} exceeds block_size "
                             f"{self.cfg.block_size}")
        pos = torch.arange(T, device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for blk in self.h:
            x = wrap_block(blk, self.cfg.remat)(x, mask)
        return self.ln_f(x)

    def _head(self, x):
        return F.matmul(x, head_table_t(self.wte.weight, x.dtype))

    def forward(self, input_ids, attention_mask=None, last_pos=None):
        """Logits (B, T, V); with ``last_pos`` (B,) only those rows, (B, 1,
        V) (the decode loops' one head row a step)."""
        x = self._backbone(input_ids, attention_mask)
        if last_pos is not None:
            idx = last_pos.long()[:, None, None].expand(-1, 1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        return self._head(x)

    def _head_nll(self, x, safe_labels):
        """Per-position nll (B, T') through the tied head: the fused
        chunked path, or the dense logits + fp32 log_softmax with
        ``head_chunk=None``."""
        table = nll_table(self.wte.weight, x.dtype)
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
        """Next-token cross-entropy: ids[t+1] predicted from the prefix <=
        t; padding positions (attention_mask == 0) are ignored."""
        labels = input_ids[:, 1:]
        if attention_mask is not None:
            labels = torch.where(attention_mask[:, 1:] != 0, labels,
                                 ignore_index)
        x = self._backbone(input_ids, attention_mask)[:, :-1]
        valid = labels != ignore_index
        nll = self._head_nll(x, torch.where(valid, labels, 0))
        return (nll * valid).sum() / valid.sum().clamp_min(1)

    # -- generation ----------------------------------------------------------
    def _embed(self, tokens, pos):
        return self.wte(tokens) + self.wpe(pos)

    @torch.no_grad()
    def generate(self, input_ids, prompt_len, max_new_tokens: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 top_k: Optional[int] = None, top_p: Optional[float] = None):
        """Fixed-buffer decoding without a cache: every step runs the
        whole (B, block_size) buffer under a length mask and reads one
        head row.  ``input_ids`` holds the prompts left-aligned;
        ``prompt_len`` is (B,) or a scalar.  Greedy at ``temperature ==
        0``, else sampled from ``generator``.  A row whose buffer is full
        stays as it is.  Returns (ids, final_len)."""
        return _generate(self, input_ids, prompt_len, max_new_tokens,
                         temperature, generator, top_k, top_p)

    def init_cache(self, batch_size: int, dtype=torch.float32):
        """Per-layer (B, n_kv_head, block_size, D) k/v buffers (one
        allocation a layer); int8 adds (B, n_kv_head, S, 1) fp32 scales."""
        cfg = self.cfg
        return _init_cache(cfg.n_layer, (batch_size, cfg.n_kv_head,
                                         cfg.block_size,
                                         cfg.n_embd // cfg.n_head),
                           dtype, self.wte.weight.device)

    def _decode_hidden(self, token, pos, cache):
        """(B,) tokens at position ``pos`` -> ((B, 1, E) final hidden
        state, cache written in place); the head is separate."""
        B = token.shape[0]
        x = self._embed(token[:, None],
                        query_positions(pos, 1, token.device).expand(B, 1))
        for i, blk in enumerate(self.h):
            x, _ = blk.decode(x, pos, cache[str(i)])
        return self.ln_f(x), cache

    @torch.no_grad()
    def prefill_cache(self, input_ids, cache=None, cache_dtype=None):
        """Seed every layer's cache with one full-buffer forward."""
        B, S = input_ids.shape
        if cache is None:
            cache = self.init_cache(B, dtype=cache_dtype
                                    or self.wte.weight.dtype)
        x = self._embed(input_ids,
                        torch.arange(S, device=input_ids.device)[None, :])
        for i, blk in enumerate(self.h):
            x, k, v = blk.prefill(x)
            _cache.seed_layer(cache[str(i)], k, v)
        return cache

    @torch.no_grad()
    def decode_chunk(self, tokens, pos, cache):
        """Cached multi-token step: ``tokens`` (B, L) at per-row positions
        ``[pos[b], pos[b] + L)`` -> (final hidden (B, L, E), cache)."""
        L = tokens.shape[1]
        x = self._embed(tokens, query_positions(pos, L, tokens.device))
        for i, blk in enumerate(self.h):
            x, _ = blk.decode_chunk(x, pos, cache[str(i)])
        return self.ln_f(x), cache

    @torch.no_grad()
    def decode_step(self, token, pos, cache):
        """(B,) tokens at ``pos`` -> ((B, V) logits for the next position,
        cache written in place)."""
        x, cache = self._decode_hidden(token, pos, cache)
        return self._head(x)[:, 0], cache

    @torch.no_grad()
    def generate_cached(self, input_ids, prompt_len, max_new_tokens: int,
                        temperature: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        cache_dtype=None, top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        prefill_mode: str = "chunked",
                        min_p: Optional[float] = None,
                        repetition_penalty: float = 1.0):
        """KV-cached ``generate``: one decode step a position against the
        static caches; greedy output is ``generate``'s.  See the module
        doc; the sampling filters are ``models.sampling``'s."""
        return _generate_cached(
            self, input_ids, prompt_len, max_new_tokens, temperature,
            generator, cache_dtype, top_k, top_p, prefill_mode, min_p,
            repetition_penalty, self.wte.weight.dtype)


def _init_cache(n_layer, shape, dtype, device):
    def layer():
        out = {"k": torch.zeros(shape, dtype=dtype, device=device),
               "v": torch.zeros(shape, dtype=dtype, device=device)}
        if dtype == torch.int8:
            sshape = shape[:3] + (1,)
            out["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                         device=device)
            out["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                         device=device)
        return out
    return {str(i): layer() for i in range(n_layer)}


def _lengths(input_ids, prompt_len):
    B = input_ids.shape[0]
    return torch.as_tensor(prompt_len, device=input_ids.device).to(
        torch.int64).expand(B).clone()


class _EvalMode:
    """The model in eval mode for a generation call (no dropout), its
    mode restored after."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        self.was = self.model.training
        self.model.eval()

    def __exit__(self, *exc):
        self.model.train(self.was)
        return False


def _generate(model, input_ids, prompt_len, max_new_tokens, temperature,
              generator, top_k, top_p):
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs generator=")
    B, S = input_ids.shape
    ids = input_ids.clone()
    cur = _lengths(input_ids, prompt_len)
    ar = torch.arange(S, device=ids.device)
    rows = torch.arange(B, device=ids.device)
    with _EvalMode(model):
        for _ in range(max_new_tokens):
            amask = (ar[None, :] < cur[:, None]).to(torch.int32)
            last = model(ids, amask,
                         last_pos=torch.clamp(cur - 1, max=S - 1))[:, 0]
            nxt = sampling.sample_token(generator, last, temperature,
                                        top_k=top_k, top_p=top_p)
            # a saturated row (cur == S) keeps its last slot
            wpos = torch.clamp(cur, max=S - 1)
            old = ids[rows, wpos]
            ids[rows, wpos] = torch.where(cur < S, nxt.to(ids.dtype), old)
            cur = torch.clamp(cur + 1, max=S)
    return ids, cur


def _generate_cached(model, input_ids, prompt_len, max_new_tokens,
                     temperature, generator, cache_dtype, top_k, top_p,
                     prefill_mode, min_p, repetition_penalty, table_dtype,
                     rolling_cache=False):
    if prefill_mode not in ("chunked", "step"):
        raise ValueError(f"prefill_mode {prefill_mode!r} not in "
                         f"('chunked', 'step')")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs generator=")
    if rolling_cache:
        prefill_mode = "step"           # slots fill as the loop walks
    B, S = input_ids.shape
    prompt_len = _lengths(input_ids, prompt_len)
    final_len = torch.clamp(prompt_len + max_new_tokens, max=S)
    # the loop's bounds: the one host read, before the loop
    end, first_gen = torch.stack([final_len.max(),
                                  prompt_len.min()]).tolist()
    kw = {"rolling": True} if rolling_cache else {}
    cache = model.init_cache(B, dtype=cache_dtype or table_dtype, **kw)
    ids = input_ids.clone()
    start = 0
    with _EvalMode(model):
        if prefill_mode == "chunked":
            model.prefill_cache(ids, cache)
            # entries at positions >= first_gen - 1 are rewritten by the
            # loop before any later position reads them
            start = max(first_gen - 1, 0)
        for i in range(start, end - 1):
            x, _ = model._decode_hidden(ids[:, i], i, cache)
            if i + 1 < first_gen:
                continue                # every row still inside its prompt
            logits = model._head(x)[:, 0]
            if repetition_penalty != 1.0:
                logits = sampling.apply_repetition_penalty(
                    logits, ids, torch.clamp(prompt_len, min=i + 1),
                    repetition_penalty)
            nxt = sampling.sample_token(generator, logits, temperature,
                                        top_k=top_k, top_p=top_p,
                                        min_p=min_p)
            # position i+1 takes a generated token iff it lies in the
            # generation window [prompt_len, final_len)
            should = (i + 1 >= prompt_len) & (i + 1 < final_len)
            ids[:, i + 1] = torch.where(should, nxt.to(ids.dtype),
                                        ids[:, i + 1])
    return ids, final_len
