"""Speculative decoding of the port against the JAX package on the CPU.

Tiny GPTs (vocab 64, block 32; a 2-layer target of width 32 and a 1-layer
draft of width 16) and a tiny Llama from the JAX package's ``init``,
carried over by ``utils.jax_interop``.  Greedy, both verify modes give the
target's greedy tokens and the JAX package's; a perfect draft, a
cross-family pair and saturation at the buffer end likewise.  Sampling
is held to the target's distribution by a total-variation bound (the two
packages' generators differ, so tokens are not compared).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import models as jmodels
from apex_tpu.models import generate_speculative as jspec

from apex_tpu_torch import models
from apex_tpu_torch.models import generate_speculative, sampling
from apex_tpu_torch.utils.jax_interop import params_from_jax

S = 32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _carry(jm, seed, tm):
    params, _ = jm.init(jax.random.PRNGKey(seed))
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return params


def _gpt(n_layer, n_embd, seed):
    kw = dict(vocab_size=64, block_size=S, n_layer=n_layer, n_head=4,
              n_embd=n_embd, dropout=0.0)
    jm = jmodels.GPT(jmodels.GPTConfig(**kw))
    tm = models.GPT(models.GPTConfig(**kw), device="cpu")
    return jm, _carry(jm, seed, tm), tm


def _llama(seed, hidden=32, layers=2, heads=4, kv=2):
    kw = dict(vocab_size=64, hidden_size=hidden, intermediate_size=2 * hidden,
              num_hidden_layers=layers, num_attention_heads=heads,
              num_key_value_heads=kv, max_position_embeddings=S,
              tie_word_embeddings=True)
    jm = jmodels.Llama(jmodels.LlamaConfig(**kw))
    tm = models.Llama(models.LlamaConfig(**kw), device="cpu")
    return jm, _carry(jm, seed, tm), tm


def _buf(seed, rows):
    rng = np.random.RandomState(seed)
    buf = np.zeros((len(rows), S), np.int32)
    for i, n in enumerate(rows):
        buf[i, :n] = rng.randint(0, 64, n)
    return buf, np.asarray(rows, np.int32)


def _check(target, draft, buf, plen, new, gamma, verify="cached"):
    """The port's speculative tokens equal its own greedy decode's and the
    JAX package's speculative tokens."""
    (jt, tp, tt), (jd, dp, td) = target, draft
    ref, n_ref = tt.generate_cached(_t(buf), _t(plen), new)
    out, n = generate_speculative(tt, td, _t(buf), _t(plen), new,
                                  gamma=gamma, verify=verify)
    jo, jn = jax.jit(lambda a, b: jspec(jt, a, jd, b, jnp.asarray(buf),
                                        jnp.asarray(plen), new, gamma=gamma,
                                        verify=verify))(tp, dp)
    np.testing.assert_array_equal(n.numpy(), n_ref.numpy())
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    return out, n


@pytest.mark.parametrize("verify", ["cached", "full"])
@pytest.mark.parametrize("gamma", [1, 3])
def test_greedy_matches_target_and_jax(verify, gamma):
    _check(_gpt(2, 32, 0), _gpt(1, 16, 1), *_buf(2, [5, 3]), 12, gamma,
           verify)


@pytest.mark.parametrize("verify", ["cached", "full"])
def test_perfect_draft(verify):
    """Draft = target: still exactly greedy."""
    target = _gpt(2, 32, 3)
    _check(target, target, *_buf(4, [4, 6]), 10, 4, verify)


def test_llama_target_gpt_draft():
    """The cross-family pair: a Llama target with a GPT draft."""
    _check(_llama(23), _gpt(1, 16, 24), *_buf(25, [6]), 10, 3)


@pytest.mark.parametrize("verify", ["cached", "full"])
def test_saturates_at_the_buffer_end(verify):
    out, n = _check(_gpt(2, 32, 8), _gpt(1, 16, 9), *_buf(10, [28]), 100, 4,
                    verify)
    assert int(n[0]) == S


def test_sampling_matches_the_target_distribution():
    """Leviathan Thm. 1: the first sampled token is distributed as the
    target's own filtered distribution, whatever the draft.  600 rows of
    one prompt in one call, each its own draw; the total-variation bound
    is the JAX test's for 600 draws."""
    _, _, target = _gpt(2, 32, 30)
    _, _, draft = _gpt(1, 16, 31)
    N, V, temp = 600, 8, 1.2
    prompt = np.random.RandomState(32).randint(0, 64, (5,))
    buf = np.zeros((N, S), np.int64)
    buf[:, :5] = prompt
    with torch.no_grad():
        logits = target(_t(buf[:1, :5]))[0, -1]
    pt = torch.softmax(sampling.filter_logits(logits.float()[None] / temp,
                                              top_k=V), dim=-1)[0].numpy()
    gen = torch.Generator().manual_seed(33)
    out, n = generate_speculative(target, draft, _t(buf), 5, 1, gamma=3,
                                  temperature=temp, top_k=V, generator=gen)
    toks = out[:, 5].numpy()
    assert (n.numpy() == 6).all()
    emp = np.bincount(toks, minlength=64) / N
    tv = 0.5 * np.abs(emp - pt).sum()
    assert tv < 0.1, tv
    # the support is the target's top-k
    assert set(np.unique(toks)) <= set(np.nonzero(pt > 0)[0].tolist())
    # later tokens stay in the vocabulary, the prompt untouched
    out, _ = generate_speculative(target, draft, _t(buf[:4]), 5, 20,
                                  gamma=3, temperature=0.8, generator=gen)
    assert (out[:, :5].numpy() == prompt).all()
    assert ((out >= 0) & (out < 64)).all()


def test_validation():
    _, _, tm = _gpt(1, 16, 34)
    ids = torch.zeros((1, S), dtype=torch.int64)
    with pytest.raises(ValueError, match="gamma"):
        generate_speculative(tm, tm, ids, 4, 4, gamma=0)
    with pytest.raises(ValueError, match="verify"):
        generate_speculative(tm, tm, ids, 4, 4, verify="magic")
    with pytest.raises(ValueError, match="generator"):
        generate_speculative(tm, tm, ids, 4, 4, temperature=0.8)
    with pytest.raises(NotImplementedError, match="cached"):
        generate_speculative(tm, tm, ids, 4, 4, temperature=0.8,
                             generator=torch.Generator(), verify="full")
    with pytest.raises(ValueError, match="exceeds the buffer"):
        generate_speculative(tm, tm, ids[:, :4], 2, 2, gamma=4)


def test_cached_verify_rounds_match_jax():
    """Round by round, the cached verify advances each row as the JAX
    package's ``spec_iteration`` does.  With draft = target it accepts
    fewer proposals than the full verify (every one): the draft's cache
    lacks the K/V of the last proposal of a fully accepted round, in the
    JAX package as in the port."""
    from apex_tpu.models import speculative as jsp
    from apex_tpu_torch.models import speculative as tsp
    jm, params, tm = _gpt(2, 32, 40)
    buf, plen = _buf(41, [5, 9, 3])
    final = np.minimum(plen + 16, S)
    jids, jcur = jnp.asarray(buf), jnp.asarray(plen)
    jt = jm.prefill_cache(params, jids)
    jd = jm.prefill_cache(params, jids)
    jround = jax.jit(lambda i, c, t, d: jsp.spec_iteration(
        jm, params, jm, params, i, c, jnp.asarray(final), jnp.asarray(buf),
        t, d, 3)[:4])
    tids, tcur = _t(buf).long(), _t(plen).long()
    tt, td = tm.prefill_cache(tids), tm.prefill_cache(tids)
    rounds = 0
    while bool((tcur < _t(final)).any()):
        jids, jcur, jt, jd = jround(jids, jcur, jt, jd)
        tids, tcur, tt, td = tsp.spec_iteration(
            tm, tm, tids, tcur, _t(final).long(), _t(buf).long(), tt, td, 3)
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        rounds += 1
    # 16 tokens a row at most 4 a round: 4 rounds if every proposal held
    assert rounds > 4
