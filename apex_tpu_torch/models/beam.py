"""Beam search over the fixed-buffer generate contract.

Counterpart of ``apex_tpu/models/beam.py``: ``num_beams`` hypotheses a
row maximize the total log-probability of the continuation, which has a
fixed length (no EOS in the buffer contract: a row stops at
``prompt_len + max_new_tokens`` or the buffer end).  ``num_beams=1`` is
greedy ``generate``.  The batch expands to ``B * num_beams`` rows and
every step is one full forward of the buffer under the length mask (the
flash route with a key-padding mask on the card), as in the JAX package.

Ties.  ``lax.top_k`` puts the lower index first among equal values; a
stable descending sort does the same here, where ``torch.topk`` promises
no order.  The loop reads nothing from the host.
"""

from __future__ import annotations

import torch

from .gpt import _EvalMode, _lengths

__all__ = ["beam_search"]

NEG = -1e30


def _top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(model, input_ids, prompt_len, max_new_tokens: int,
                num_beams: int = 4):
    """Returns ``(ids (B, S), final_len (B,), score (B,))``: the best beam
    a row and its total continuation log-probability (fp32).  ``model``
    is any module with the ``model(ids, attention_mask) -> (B, S, V)``
    contract (GPT, Llama)."""
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    B, S = input_ids.shape
    K = num_beams
    dev = input_ids.device
    prompt_len = _lengths(input_ids, prompt_len)
    final_len = torch.clamp(prompt_len + max_new_tokens, max=S)
    pgrid = torch.arange(S, device=dev)[None, :]

    ids = input_ids.repeat_interleave(K, dim=0)          # (B*K, S)
    # all beams start identical: only beam 0 is live, or the first step
    # would pick the same token K times
    scores = torch.where(torch.arange(K, device=dev)[None, :] == 0, 0.0,
                         NEG).expand(B, K).clone()
    cur_len = prompt_len.clone()
    with _EvalMode(model):
        for _ in range(max_new_tokens):
            active = cur_len < final_len                 # (B,)
            lens = cur_len.repeat_interleave(K)
            amask = (pgrid < lens[:, None]).to(torch.int32)
            logits = model(ids, amask)
            idx = torch.clamp(lens - 1, 0, S - 1)
            last = torch.gather(logits, 1, idx[:, None, None].expand(
                -1, 1, logits.shape[-1]))[:, 0]          # (B*K, V)
            V = last.shape[-1]
            logp = torch.log_softmax(last.float(), dim=-1)
            total = scores[:, :, None] + logp.reshape(B, K, V)
            top_scores, top_idx = _top_k(total.reshape(B, K * V), K)
            beam_idx = top_idx // V                      # (B, K)
            tok = (top_idx % V).to(ids.dtype)

            # reorder beams, then append the chosen token at cur_len, for
            # active rows only: a finished row keeps its ids and scores
            # frozen together
            prev = ids.reshape(B, K, S)
            reord = torch.gather(prev, 1,
                                 beam_idx[:, :, None].expand(B, K, S))
            wpos = torch.clamp(cur_len, 0, S - 1)
            cols = reord.scatter(2, wpos[:, None, None].expand(B, K, 1),
                                 tok[:, :, None])
            ids = torch.where(active[:, None, None], cols,
                              prev).reshape(B * K, S)
            scores = torch.where(active[:, None], top_scores, scores)
            cur_len = torch.where(active, cur_len + 1, cur_len)
    best = torch.argmax(scores, dim=-1)                  # (B,)
    out = torch.gather(ids.reshape(B, K, S), 1,
                       best[:, None, None].expand(B, 1, S))[:, 0]
    return out, final_len, torch.gather(scores, 1, best[:, None])[:, 0]
