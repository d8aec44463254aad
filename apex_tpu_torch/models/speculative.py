"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of ``apex_tpu/models/speculative.py`` (Leviathan et al.,
2023).  A cheap draft proposes ``gamma`` tokens; the target scores the
proposed prefix in one pass, and the longest prefix it agrees with is
accepted plus one token of its own, so every iteration advances a row by
1 to gamma + 1 tokens.  Greedy (``temperature == 0``), the output is
exactly the target's greedy continuation.  Draft and target only share
the ``model(ids, attention_mask) -> (B, S, V)`` contract and the decode
calls below, so the families pair freely (a GPT draft for a Llama
target) where the vocabularies agree.

Two verify modes, as in the JAX package:

- ``verify="cached"`` (default): both models keep KV caches seeded by a
  chunked prefill; the draft proposes with one-token ``decode_chunk``
  steps at per-row positions and the target scores all gamma + 1
  positions with one ``decode_chunk``.  Rejected positions need no
  rewind: the next iteration's chunk rewrites them before any query
  reads them.
- ``verify="full"``: both re-run full forwards of the buffer under the
  length mask each iteration (the flash route with a key-padding mask on
  the card); the oracle of the cached path.

Speculative sampling (``temperature > 0``, cached verify only) follows
Thm. 1 of the paper: draft token x is accepted with probability
min(1, p_t(x) / p_d(x)) and a rejection resamples from max(0, p_t -
p_d), so the output is distributed as sampling the target itself with
the same filters (``sampling.filter_logits``).  The draws come from an
explicit ``torch.Generator`` where the JAX package splits a key: the two
agree in distribution, not token for token.

The JAX package loops on the device (``lax.while_loop``).  The port's
loop is Python: it reads its condition from the host once an iteration
and nothing else; ``spec_iteration`` reads nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from .gpt import _EvalMode, _lengths
from .sampling import filter_logits, sample_token

__all__ = ["generate_speculative", "spec_iteration"]


def _head_logits(model, h: torch.Tensor) -> torch.Tensor:
    """(B, L, V) logits from final hidden states, for any family."""
    return model._head(h)


def _write_at(ids: torch.Tensor, pos: torch.Tensor, tok: torch.Tensor,
              can: torch.Tensor) -> torch.Tensor:
    """``ids`` with ``tok[b]`` at ``pos[b]`` (clamped to the buffer) where
    ``can[b]``; a new tensor."""
    S = ids.shape[1]
    p = torch.clamp(pos, max=S - 1)[:, None]
    old = torch.gather(ids, 1, p)
    return ids.scatter(1, p, torch.where(can[:, None], tok[:, None].to(
        ids.dtype), old))


@torch.no_grad()
def generate_speculative(target, draft, input_ids, prompt_len,
                         max_new_tokens: int, gamma: int = 4,
                         verify: str = "cached", temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         top_k=None, top_p=None):
    """Speculative decoding; returns ``(ids, final_len)`` with
    ``GPT.generate``'s contract: rows left-aligned in the (B, S) buffer,
    generation to ``prompt_len + max_new_tokens`` or the buffer end,
    positions past ``final_len`` keep the input's content.
    ``temperature > 0`` (cached verify only) samples, from
    ``generator``."""
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if verify not in ("cached", "full"):
        raise ValueError(f"verify {verify!r} not in ('cached', 'full')")
    if temperature > 0.0:
        if generator is None:
            raise ValueError("sampling (temperature > 0) needs generator=")
        if verify != "cached":
            raise NotImplementedError(
                "speculative sampling rides the cached-verify path")
    with _EvalMode(target), _EvalMode(draft):
        if verify == "cached":
            return _generate_cached_verify(
                target, draft, input_ids, prompt_len, max_new_tokens,
                gamma, temperature, generator, top_k, top_p)
        return _generate_full_verify(target, draft, input_ids, prompt_len,
                                     max_new_tokens, gamma)


def _generate_full_verify(target, draft, input_ids, prompt_len,
                          max_new_tokens, gamma):
    B, S = input_ids.shape
    orig = input_ids
    cur_len = _lengths(input_ids, prompt_len)
    final_len = torch.clamp(cur_len + max_new_tokens, max=S)
    pgrid = torch.arange(S, device=orig.device)[None, :]

    def next_token(model, ids, length):
        """Greedy next token a row, read at position length - 1."""
        amask = (pgrid < length[:, None]).to(torch.int32)
        logits = model(ids, amask)
        idx = torch.clamp(length - 1, 0, S - 1)
        last = torch.gather(logits, 1, idx[:, None, None].expand(
            -1, 1, logits.shape[-1]))[:, 0]
        return torch.argmax(last, dim=-1).to(ids.dtype)

    ids = orig
    while bool((cur_len < final_len).any()):        # the one host read
        active = cur_len < final_len
        # 1. the draft proposes gamma greedy tokens (rows stop at the
        # window's edge; inactive rows propose nothing)
        ids_d, len_d, dtoks = ids, cur_len, []
        for _ in range(gamma):
            t = next_token(draft, ids_d, len_d)
            can = len_d < final_len
            ids_d = _write_at(ids_d, len_d, t, can)
            dtoks.append(t)
            len_d = torch.where(can, len_d + 1, len_d)
        dtoks = torch.stack(dtoks, dim=1)              # (B, gamma)
        # 2. the target scores the proposed prefix in one forward
        amask = (pgrid < len_d[:, None]).to(torch.int32)
        tgt_next = torch.argmax(target(ids_d, amask), dim=-1)   # (B, S)
        # 3. the longest agreeing prefix; proposal j is eligible only if
        # the correction slot after it still fits the window
        offs = torch.arange(gamma, device=ids.device)[None, :]
        vpos = torch.clamp(cur_len[:, None] - 1 + offs, 0, S - 1)
        agree = dtoks == torch.gather(tgt_next, 1, vpos).to(dtoks.dtype)
        eligible = (cur_len[:, None] + offs) < (final_len[:, None] - 1)
        n_acc = torch.cumprod((agree & eligible).to(torch.int64),
                              dim=1).sum(dim=1)
        # 4. the target's token after the accepted prefix (the bonus
        # token when all agree)
        cpos = torch.clamp(cur_len - 1 + n_acc, 0, S - 1)
        ctok = torch.gather(tgt_next, 1, cpos[:, None])[:, 0].to(ids.dtype)
        ids, cur_len = _rebuild(ids_d, orig, cur_len, final_len, n_acc,
                                ctok, active, pgrid)
    return ids, final_len


def _rebuild(ids_d, orig, cur_len, final_len, n_acc, ctok, active, pgrid):
    """The accepted zone from ``ids_d``, the correction at cur_len +
    n_acc, the input buffer's content past it (rejected proposals leave
    no trace); the new lengths."""
    corr_at = cur_len + n_acc
    keep = pgrid < corr_at[:, None]
    is_corr = (pgrid == corr_at[:, None]) & active[:, None]
    ids = torch.where(keep, ids_d, torch.where(is_corr, ctok[:, None],
                                               orig))
    new_len = torch.where(active, torch.clamp(corr_at + 1, max=final_len),
                          cur_len)
    return ids, new_len


@torch.no_grad()
def spec_iteration(target, draft, ids, cur_len, final_len, orig, t_cache,
                   d_cache, gamma: int, generator=None,
                   temperature: float = 0.0, top_k=None, top_p=None):
    """One draft-propose / target-verify round over per-row state, the
    block ``generate_speculative`` loops (and a serving engine runs once a
    tick).  Every active row advances 1 to gamma + 1 positions; ``orig``
    is the content restored past the correction point.  The caches are
    written in place.  Returns ``(ids, new_len, t_cache, d_cache)``."""
    B, S = ids.shape
    L = gamma + 1
    sample = temperature > 0.0
    dev = ids.device
    pgrid = torch.arange(S, device=dev)[None, :]

    def probs_of(logits):
        # the filtered sampling distribution (scale, top-k, top-p)
        fl = filter_logits(logits.float() / temperature, top_k=top_k,
                           top_p=top_p)
        return torch.softmax(fl, dim=-1)

    active = cur_len < final_len
    # 1. the draft proposes gamma tokens with one-token cached steps at
    # per-row positions (posd: the last known position)
    ids_d, posd = ids, cur_len - 1
    dtoks, dprobs = [], []
    for _ in range(gamma):
        tok_in = torch.gather(ids_d, 1, torch.clamp(posd, 0, S - 1)[:, None])
        h, d_cache = draft.decode_chunk(tok_in, posd, d_cache)
        logits = _head_logits(draft, h)[:, 0]
        if sample:
            pd = probs_of(logits)
            # a categorical draw (Gumbel-max) of the log-probabilities
            t = sample_token(generator, torch.log(pd + 1e-30)).to(ids.dtype)
            dprobs.append(pd)
        else:
            t = torch.argmax(logits, dim=-1).to(ids.dtype)
        can = (posd + 1) < final_len
        ids_d = _write_at(ids_d, posd + 1, t, can)
        dtoks.append(t)
        posd = torch.where(can, posd + 1, posd)
    dtoks = torch.stack(dtoks, dim=1)                  # (B, gamma)

    # 2. the target scores the chunk against its cache.  The chunk's
    # start clamps to S - L near the buffer end; ``off`` re-aligns the
    # verify rows (re-ingested entries recompute to the same values)
    ar = torch.arange(L, device=dev)[None, :]
    pos0 = torch.clamp(torch.clamp(cur_len - 1, max=S - L), min=0)
    chunk = torch.gather(ids_d, 1, pos0[:, None] + ar)
    th, t_cache = target.decode_chunk(chunk, pos0, t_cache)
    t_logits = _head_logits(target, th)                # (B, L, V)
    off = cur_len - 1 - pos0
    idx = torch.clamp(off[:, None] + ar, 0, L - 1)
    # row j is position cur - 1 + j
    t_logits = torch.gather(t_logits, 1, idx[:, :, None].expand(
        -1, -1, t_logits.shape[-1]))

    offs = torch.arange(gamma, device=dev)[None, :]
    eligible = (cur_len[:, None] + offs) < (final_len[:, None] - 1)
    if sample:
        pt = probs_of(t_logits)                        # (B, L, V)
        pd = torch.stack(dprobs, dim=1)                # (B, gamma, V)
        # 3. accept x_j with probability min(1, p_t(x_j) / p_d(x_j))
        x = dtoks.long()[..., None]
        pt_x = torch.gather(pt[:, :gamma], -1, x)[..., 0]
        pd_x = torch.gather(pd, -1, x)[..., 0]
        u = torch.rand((B, gamma), generator=generator, device=dev)
        accept = u * pd_x < pt_x
        n_acc = torch.cumprod((accept & eligible).to(torch.int64),
                              dim=1).sum(dim=1)
        # 4. the token after the accepted run: from the residual max(0,
        # p_t - p_d) on a true rejection, from p_t itself where the run
        # ended for eligibility or took every proposal (the bonus)
        nai = torch.clamp(n_acc, 0, gamma)[:, None]
        V = pt.shape[-1]
        pt_row = torch.gather(pt, 1, nai[..., None].expand(-1, 1, V))[:, 0]
        pd_pad = torch.cat([pd, pd.new_zeros((B, 1, V))], dim=1)
        pd_row = torch.gather(pd_pad, 1,
                              nai[..., None].expand(-1, 1, V))[:, 0]
        el_pad = torch.cat([eligible, eligible.new_zeros((B, 1))], dim=1)
        was_rejection = torch.gather(el_pad, 1, nai)[:, 0]
        resid = torch.clamp(pt_row - torch.where(was_rejection[:, None],
                                                 pd_row, 0.0), min=0.0)
        norm = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(norm > 1e-12, resid / norm, pt_row)
        ctok = sample_token(generator, torch.log(resid + 1e-30)).to(
            ids.dtype)
    else:
        tgt_next = torch.argmax(t_logits, dim=-1)     # (B, L)
        # 3. the longest agreeing prefix (the correction slot must fit)
        agree = dtoks == tgt_next[:, :gamma].to(dtoks.dtype)
        n_acc = torch.cumprod((agree & eligible).to(torch.int64),
                              dim=1).sum(dim=1)
        # 4. the corrected token: the target's choice after the run
        ctok = torch.gather(tgt_next, 1, torch.clamp(
            n_acc, 0, gamma)[:, None])[:, 0].to(ids.dtype)

    # 5. rebuild ids: the accepted zone, the correction, the rest restored
    ids_new, new_len = _rebuild(ids_d, orig, cur_len, final_len, n_acc,
                                ctok, active, pgrid)
    return ids_new, new_len, t_cache, d_cache


def _generate_cached_verify(target, draft, input_ids, prompt_len,
                            max_new_tokens, gamma, temperature, generator,
                            top_k, top_p):
    B, S = input_ids.shape
    if gamma + 1 > S:
        raise ValueError(f"gamma+1={gamma + 1} exceeds the buffer "
                         f"length {S}")
    orig = input_ids
    cur_len = _lengths(input_ids, prompt_len)
    final_len = torch.clamp(cur_len + max_new_tokens, max=S)
    t_cache = target.prefill_cache(orig)
    d_cache = draft.prefill_cache(orig)
    ids = orig
    while bool((cur_len < final_len).any()):        # the one host read
        ids, cur_len, t_cache, d_cache = spec_iteration(
            target, draft, ids, cur_len, final_len, orig, t_cache, d_cache,
            gamma, generator, temperature, top_k, top_p)
    return ids, final_len
